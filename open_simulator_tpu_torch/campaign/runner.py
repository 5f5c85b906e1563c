"""The fleet campaign runner (the reference's ``campaign/runner.py``).

Streams a fleet of recorded cluster dumps through the bucketed engine
with training-pipeline-grade fault tolerance. The defining property: **no
single cluster can take down, corrupt, or silently skew a campaign.**

Per-cluster fault boundary
    Each cluster loads, admits, simulates, and audits inside one error
    boundary. Failures map to the structured taxonomy (``E_SOURCE`` for
    unparseable dumps, ``E_AUDIT`` for invariant violations, admission
    codes for bad specs, ``E_INTERNAL`` for anything else) and land in a
    **quarantine record** with the error and retry history; the campaign
    continues. Failures the device fault classifier
    (``resilience/faults.py``) calls *transient* — transfer trouble,
    bare OSErrors around dump IO — retry with the full-jitter backoff
    schedule from ``resilience/retry.py`` (a fleet of workers must not
    retry in lockstep); deterministic-classed faults quarantine on
    attempt 1 instead of burning the budget reproducing themselves.

Checkpoint / resume
    One fsynced journal line per settled cluster (completed OR
    quarantined), fingerprint = source digest + EngineConfig hash,
    following the §11 SweepJournal schema. ``campaign run --resume
    <id|last>`` after a SIGKILL verifies the fleet digest, replays the
    settled clusters from the journal (quarantined clusters are reported
    once — not re-run, not lost) and continues from the first unsettled
    one; the fleet report digest is bit-identical to an uninterrupted
    run because the report is always built from the journal-schema rows.

Audit gate
    ``campaign/audit.py`` re-proves every result against the engine's
    own contracts; a violation quarantines the cluster with ``E_AUDIT``
    rather than polluting fleet aggregates.

Shared launches
    Clusters that land in the same shape bucket run as the lanes of one
    fleet launch (``campaign/lanes.py``) — the report's ``buckets`` map
    is the witness, ``launches`` the count.

Cancellation
    An armed ``lifecycle`` cancel scope is observed at every cluster
    boundary with partial results.

Not ported yet (ROADMAP queue 1, item 11): the run ledger (the
reference's per-cluster RunRecords and campaign summary event), the
campaign metrics and the flight recorder's quarantine events. The port
behaves as the reference does with no ledger configured. ``device``
(None: the card) is where each cluster runs.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from open_simulator_tpu_torch.campaign.audit import AuditError, audit_result
from open_simulator_tpu_torch.campaign.fleet import (
    ClusterEntry,
    discover_fleet,
    fleet_digest,
)
from open_simulator_tpu_torch.campaign.report import build_report
from open_simulator_tpu_torch.errors import SimulationError
from open_simulator_tpu_torch.resilience import journal as journal_mod
from open_simulator_tpu_torch.resilience import lifecycle
from open_simulator_tpu_torch.resilience.retry import run_with_retries

_log = logging.getLogger(__name__)

CAMPAIGN_JOURNAL_SUFFIX = ".campaign.jsonl"


@dataclass
class CampaignOptions:
    """One campaign's knobs (CLI flags / REST body fields map 1:1)."""

    fleet: str = ""                  # dir or manifest (or pass entries=)
    apps_dir: str = ""               # optional scenario apps, deployed to
    #                                  EVERY cluster (manifest directory)
    scenario: str = "replay"         # scenario-set name on records
    max_clusters: int = 0            # 0 = the whole fleet
    retries: int = 2                 # transient retries per cluster
    backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    resume: str = ""                 # campaign-id prefix or "last"
    checkpoint: Optional[bool] = None  # None = auto (on when a dir exists)
    audit: bool = True               # post-hoc invariant audit per cluster
    config_overrides: Dict[str, Any] = dc_field(default_factory=dict)
    # fleet lanes (campaign/lanes.py): same-bucket clusters execute as
    # lanes of ONE launch instead of one serial dispatch each; per-lane
    # quarantine semantics are unchanged (bit-identical rows, asserted
    # in tier-1). False restores the pure serial boundary.
    fleet_lanes: bool = True
    lane_width: int = 8              # clusters per batched launch
    device: Optional[str] = None     # torch device (None: the card)


# ---- journal -------------------------------------------------------------


class CampaignJournal(journal_mod.DurableJournal):
    """Append-only per-campaign settlement log, §11 SweepJournal-shaped:

      {"kind": "header", "campaign_id", "ts", "fleet_digest", "scenario",
       "n_clusters", "surface"}
      {"kind": "cluster", "cluster", "fingerprint": {"source", "engine"},
       "row": {...report row...}}
      {"kind": "quarantine", "cluster", "row": {...quarantine record...}}
      {"kind": "done", "digest", "completed", "quarantined"}

    Lines are appended only when a cluster is SETTLED (hosted outputs or
    a final quarantine verdict in hand) and fsynced, so a SIGKILL
    resumes from the last settled cluster. Records ride the shared
    CRC-framed ``DurableJournal`` format (ARCH §19): a torn final line
    resumes from the prefix, mid-file corruption is ``E_CORRUPT``, and
    an unwritable dir takes the shared checkpointing_disabled rung.
    """

    KIND = "campaign"

    def __init__(self, path: str, header: Dict[str, Any],
                 records: Optional[List[Dict[str, Any]]] = None,
                 done: Optional[Dict[str, Any]] = None):
        super().__init__(path, header)
        self.records = records or []
        self.done = done

    @property
    def campaign_id(self) -> str:
        return self.header["campaign_id"]

    @classmethod
    def create(cls, root: str, fleet_dig: str, scenario: str,
               n_clusters: int, surface: str = "campaign"
               ) -> "CampaignJournal":
        os.makedirs(root, exist_ok=True)
        # shared keep-N-completed policy (resilience/lifecycle.py):
        # finished campaign journals are bounded, unfinished ones stay
        lifecycle.prune_journals(root, CAMPAIGN_JOURNAL_SUFFIX)
        campaign_id = uuid.uuid4().hex[:12]
        header = {"kind": "header", "campaign_id": campaign_id,
                  "ts": round(time.time(), 6), "fleet_digest": fleet_dig,
                  "scenario": scenario, "n_clusters": int(n_clusters),
                  "surface": surface}
        journal = cls(
            os.path.join(root, campaign_id + CAMPAIGN_JOURNAL_SUFFIX),
            header)
        journal._append(header)
        return journal

    @classmethod
    def load(cls, root: str, token: str) -> "CampaignJournal":
        """Resolve ``token`` (unique campaign-id prefix or ``last``) and
        run the strict reader: only a torn FINAL line (crash mid-append)
        is dropped; mid-file corruption or a sequence gap is a
        structured ``E_CORRUPT``."""
        path = journal_mod.resolve_journal_path(
            root, token, CAMPAIGN_JOURNAL_SUFFIX, "campaign")
        scan = journal_mod.read_journal(path, cls.KIND)
        header, records, done = None, [], None
        for rec in scan.records:
            kind = rec.get("kind")
            if kind == "header":
                header = rec
            elif kind in ("cluster", "quarantine"):
                records.append(rec)
            elif kind == "done":
                done = rec
        if header is None:
            raise lifecycle.ResumeError(
                f"checkpoint {os.path.basename(path)} has no header line",
                ref="resume")
        journal = cls(path, header, records, done)
        journal._adopt_scan(scan)
        return journal

    def verify(self, fleet_dig: str, scenario: str) -> None:
        """Resume contract: same fleet (names + source digests + engine
        overrides) and scenario, or the replayed rows answer a different
        question."""
        if self.header.get("fleet_digest") != fleet_dig:
            raise lifecycle.ResumeError(
                "fleet drifted since the checkpoint (a dump changed, was "
                "added, or removed, or the engine overrides differ): "
                "settled clusters answer a different question",
                ref=f"campaign/{self.campaign_id}", field="fleet_digest",
                hint="re-run without --resume, or restore the original "
                     "fleet and options")
        if self.header.get("scenario") != scenario:
            raise lifecycle.ResumeError(
                f"scenario drifted since the checkpoint "
                f"({self.header.get('scenario')!r} -> {scenario!r})",
                ref=f"campaign/{self.campaign_id}", field="scenario")

    def append_cluster(self, name: str, fingerprint: Dict[str, str],
                       row: Dict[str, Any]) -> None:
        rec = {"kind": "cluster", "cluster": name,
               "fingerprint": fingerprint, "row": row}
        self._append(rec)
        self.records.append(rec)

    def append_quarantine(self, name: str, row: Dict[str, Any]) -> None:
        rec = {"kind": "quarantine", "cluster": name, "row": row}
        self._append(rec)
        self.records.append(rec)

    def finish(self, digest: str, completed: int, quarantined: int) -> None:
        rec = {"kind": "done", "digest": digest,
               "completed": int(completed), "quarantined": int(quarantined)}
        self._append(rec)
        self.done = rec

    def settled(self) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
        """(completed rows, quarantine rows) recorded so far."""
        rows = [r["row"] for r in self.records if r["kind"] == "cluster"]
        quars = [r["row"] for r in self.records
                 if r["kind"] == "quarantine"]
        return rows, quars


def resolve_campaign(token: str) -> CampaignJournal:
    """Load a campaign journal by id prefix / ``last`` (the ``campaign
    report`` surface)."""
    return CampaignJournal.load(lifecycle.checkpoint_dir() or "", token)


# ---- per-cluster work ----------------------------------------------------


def load_and_admit(path_or_entry) -> Any:
    """The campaign's load+admission boundary, exposed standalone (the
    fuzz suite drives it): resolve the source, parse the dump, run the
    admission validators — every failure is a structured
    ``SimulationError`` (``E_SOURCE`` for parse/loader trouble, the
    admission taxonomy for bad specs), never a raw traceback."""
    from open_simulator_tpu_torch.resilience.admission import admit

    entry = (path_or_entry if isinstance(path_or_entry, ClusterEntry)
             else ClusterEntry(name=str(path_or_entry),
                               path=str(path_or_entry), digest=""))
    cluster = entry.load()  # ClusterSourceError boundary lives in the source
    try:
        admit(cluster)
    except SimulationError:
        raise
    except Exception as e:  # noqa: BLE001 — a validator crash on a spec
        # shape it never anticipated is still a structured verdict
        raise SimulationError(
            f"admission crashed on {entry.name}: {type(e).__name__}: {e}",
            code="E_INTERNAL", ref=f"source/{entry.path or entry.name}",
            hint="file the dump as a repro for the admission validators",
        ) from e
    return cluster


def _scenario_apps(opts: CampaignOptions) -> List[Any]:
    if not opts.apps_dir:
        return []
    from open_simulator_tpu_torch.core import AppResource
    from open_simulator_tpu_torch.k8s.loader import load_resources_from_directory

    return [AppResource(name=opts.scenario,
                        resources=load_resources_from_directory(
                            opts.apps_dir))]


def _top_rejects(result) -> List[List[Any]]:
    """Per-cluster explain aggregate: total per-op elimination counts over
    the unscheduled pods, top-N by count (deterministic tiebreak)."""
    if result.fail_counts is None or not result.unscheduled_pods:
        return []
    snap = result.snapshot
    unsched = {id(u.pod) for u in result.unscheduled_pods}
    idx = [i for i, p in enumerate(snap.pods) if id(p) in unsched]
    counts = np.asarray(result.fail_counts)[idx].sum(axis=0)
    pairs = [[result.op_names[i], int(c)] for i, c in enumerate(counts)
             if int(c) > 0 and i < len(result.op_names)]
    pairs.sort(key=lambda kv: (-kv[1], kv[0]))
    from open_simulator_tpu_torch.campaign.report import TOP_OPS

    return pairs[:TOP_OPS]


def cluster_row(entry: ClusterEntry, result, audit) -> Dict[str, Any]:
    """The per-cluster report/journal row — ONE definition shared by the
    serial boundary and the fleet-lane path, so both produce
    byte-identical journal lines and report digests."""
    from open_simulator_tpu_torch.engine.buckets import bucket_shape

    snap = result.snapshot
    n, p = bucket_shape(snap.n_nodes, snap.n_pods)
    return {
        "cluster": entry.name,
        "source": entry.digest,
        "n_nodes": int(snap.n_real_nodes),
        "n_pods": int(snap.n_pods),
        "placed": len(result.scheduled_pods),
        "unplaced": len(result.unscheduled_pods),
        "cpu_pct": float(audit.cpu_pct),
        "mem_pct": float(audit.mem_pct),
        "bucket": [int(n), int(p)],
        "top_rejects": _top_rejects(result),
        "audit_ok": bool(audit.ok),
    }


def quarantine_row(entry: ClusterEntry, err: Dict[str, Any],
                   attempts: int = 1) -> Dict[str, Any]:
    """The quarantine record — shared shape between the serial boundary
    and the fleet-lane path (per-lane quarantine semantics unchanged)."""
    return {
        "cluster": entry.name,
        "source": entry.digest,
        "error": err,
        "attempts": int(attempts),
        "transient_retries": max(0, int(attempts) - 1),
    }


def _run_one(entry: ClusterEntry, apps, opts: CampaignOptions,
             campaign_id: str) -> Tuple[str, Dict[str, Any],
                                        Dict[str, str]]:
    """Load/simulate/audit ONE cluster inside the fault boundary.

    Returns ("cluster", row, fingerprint) on success or
    ("quarantine", quarantine_row, {}) on a final failure — this function
    never raises for per-cluster trouble (cancellation excepted: a
    CancelledError must stop the campaign, not quarantine a cluster)."""
    from open_simulator_tpu_torch.engine.scheduler import make_config
    from open_simulator_tpu_torch.telemetry import ledger

    attempts = {"n": 0}

    def attempt() -> Tuple[Dict[str, Any], Dict[str, str]]:
        attempts["n"] += 1
        from open_simulator_tpu_torch import core

        cluster = load_and_admit(entry)
        result = core.simulate(cluster, apps,
                               config_overrides=dict(opts.config_overrides),
                               device=opts.device)
        cfg = make_config(result.snapshot, **{
            k: v for k, v in opts.config_overrides.items()
            if not k.startswith("_")})
        audit = audit_result(result)
        if opts.audit and not audit.ok:
            raise AuditError(audit, ref=f"cluster/{entry.name}")
        row = cluster_row(entry, result, audit)
        fingerprint = {"source": entry.digest,
                       "engine": ledger.engine_config_hash(cfg)}
        return row, fingerprint

    try:
        # retries are gated by the device fault classifier (the
        # run_with_retries default): only transient-classed failures —
        # transfer trouble, bare OSErrors around dump IO — spend the
        # backoff budget. The old (OSError, RuntimeError) blanket
        # retried deterministic bugs (an OOM, a NaN, a ValueError deep
        # in decode surfaced as RuntimeError) three times each, wasting
        # the budget and burying the root cause under attempt noise in
        # the quarantine record's history.
        row, fingerprint = run_with_retries(
            attempt, retries=opts.retries, backoff_s=opts.backoff_s,
            max_backoff_s=opts.max_backoff_s, jitter=True)
        return "cluster", row, fingerprint
    except lifecycle.CancelledError:
        raise  # a deadline is the campaign's story, not this cluster's
    except SimulationError as e:
        err = e.to_dict()
    except Exception as e:  # noqa: BLE001 — the boundary's last line of
        # defense: an unexpected crash quarantines the cluster (with the
        # E_INTERNAL marker that says "this is our bug"), never the fleet
        err = {"code": "E_INTERNAL", "ref": f"cluster/{entry.name}",
               "field": "", "hint": "file the dump as a repro",
               "message": f"{type(e).__name__}: {e}"}
    _log.warning("campaign %s: cluster %s quarantined [%s] after %d "
                 "attempt(s): %s", campaign_id, entry.name,
                 err.get("code"), attempts["n"], err.get("message"))
    return "quarantine", quarantine_row(entry, err, attempts["n"]), {}


# ---- campaign ------------------------------------------------------------


def run_campaign(opts: CampaignOptions,
                 entries: Optional[List[ClusterEntry]] = None
                 ) -> Dict[str, Any]:
    """Run (or resume) a fleet campaign; returns the fleet report dict."""
    t0 = time.perf_counter()
    entries = list(entries) if entries is not None else discover_fleet(
        opts.fleet)
    if opts.max_clusters > 0:
        entries = entries[:opts.max_clusters]
    apps = _scenario_apps(opts)
    fdig = fleet_digest(entries, opts.scenario, opts.config_overrides)

    # ---- journal: resume (verify + replay) or create fresh -------------
    root = lifecycle.checkpoint_dir()
    journal: Optional[CampaignJournal] = None
    resumed = 0
    if opts.resume:
        journal = CampaignJournal.load(root or "", opts.resume)
        journal.verify(fdig, opts.scenario)
        resumed = len(journal.records)
        _log.info("resumed campaign %s: %d settled cluster(s) replayed",
                  journal.campaign_id, resumed)
    elif opts.checkpoint or (opts.checkpoint is None and root):
        if not root:
            raise ValueError(
                "checkpoint=True needs a checkpoint directory: set "
                "SIMON_CHECKPOINT_DIR (or SIMON_LEDGER_DIR)")
        try:
            journal = CampaignJournal.create(root, fdig, opts.scenario,
                                             len(entries))
        except OSError as e:
            _log.warning("checkpoint dir %s is unwritable (%s); campaign "
                         "checkpointing disabled for this run", root, e)
            journal = None

    campaign_id = (journal.campaign_id if journal is not None
                   else uuid.uuid4().hex[:12])
    rows, quars = (journal.settled() if journal is not None else ([], []))
    settled = {r["cluster"] for r in rows} | {q["cluster"] for q in quars}

    def _partial() -> Dict[str, Any]:
        return {"campaign_id": campaign_id,
                "clusters_settled": len(rows) + len(quars),
                "clusters_total": len(entries),
                "quarantined": sorted(q["cluster"] for q in quars)}

    def _settle(entry: ClusterEntry, kind: str, row: Dict[str, Any],
                fingerprint: Dict[str, str]) -> None:
        if kind == "cluster":
            rows.append(row)
            if journal is not None:
                journal.append_cluster(entry.name, fingerprint, row)
        else:
            quars.append(row)
            if journal is not None:
                journal.append_quarantine(entry.name, row)

    pending = [e for e in entries if e.name not in settled]
    launches = 0
    if opts.fleet_lanes:
        # fleet lanes (§13 bucket map cashed in): same-bucket clusters
        # pack as lanes of one launch; everything the lane path cannot
        # prove equivalent falls back to the serial boundary below
        from open_simulator_tpu_torch.campaign import lanes as fleet

        launches = fleet.run_fleet(pending, apps, opts, campaign_id,
                                   _settle, _partial)
    else:
        for entry in pending:
            # deadline/drain boundary: a cancelled campaign stops BETWEEN
            # clusters with its journal intact (resume picks it back up)
            lifecycle.check_current("campaign cluster boundary",
                                    partial=_partial)
            kind, row, fingerprint = _run_one(entry, apps, opts,
                                              campaign_id)
            _settle(entry, kind, row, fingerprint)
            launches += 1

    report = build_report(campaign_id, rows, quars,
                          wall_s=time.perf_counter() - t0,
                          resumed_clusters=resumed)
    # the fleet-lane witness: DISPATCH BOUNDARIES this process paid —
    # one per serial-boundary cluster (whatever retries happened inside
    # it, and even if it failed before reaching the device), one per
    # batched chunk. Same-bucket fleets batch, so launches < clusters is
    # the witness; this is NOT a device-execution count. OUTSIDE the
    # digested core, like wall_s — resumed runs replay rows without
    # launching.
    report["launches"] = int(launches)
    if journal is not None and journal.done is None:
        journal.finish(report["digest"], len(rows), len(quars))
    # surface the storage degradation rung on the report itself (outside
    # the digested core, like wall_s): the fleet run is complete and
    # correct, but cannot be resumed past the last durable record
    if journal is not None and journal.broken:
        report["checkpointing_disabled"] = True
    return report


def report_from_journal(journal: CampaignJournal) -> Dict[str, Any]:
    """Rebuild the fleet report from a journal (``campaign report``);
    works on unfinished journals too — the crash-inspection view."""
    rows, quars = journal.settled()
    return build_report(journal.campaign_id, rows, quars)


def run_audit(cluster_path: str,
              config_overrides: Optional[Dict[str, Any]] = None,
              device=None) -> Tuple[Any, Dict[str, Any]]:
    """Standalone audit surface: one cluster end to end on `device` (None:
    the card), returns (AuditReport, row-ish summary)."""
    from open_simulator_tpu_torch import core

    entry = ClusterEntry(
        name=os.path.splitext(os.path.basename(cluster_path))[0],
        path=cluster_path, digest="")
    cluster = load_and_admit(entry)
    result = core.simulate(cluster, [],
                           config_overrides=dict(config_overrides or {}),
                           device=device)
    rep = audit_result(result)
    return rep, {"cluster": entry.name,
                 "placed": len(result.scheduled_pods),
                 "unplaced": len(result.unscheduled_pods)}
