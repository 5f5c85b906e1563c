"""Fleet campaigns: fault-isolated batch simulation over recorded dumps
(the reference's ``campaign/``), on the port's engine.

Four cooperating pieces, and the fleet lanes (``lanes.py``: same-bucket
clusters as the lanes of one launch of the step kernel's fleet form):

  fleet    discovery — a directory/manifest of recorded cluster dumps
           becomes an ordered list of (name, loader, source digest)
           entries; synthetic fleet writer for bench/smoke/tests
  audit    the placement invariant auditor: post-hoc vectorized proof
           that a SimulateResult respects the engine's own contracts
           (bindings on live nodes, consumption within allocatable,
           forced binds honored); violations are E_AUDIT
  runner   the campaign loop: per-cluster fault boundary + quarantine
           records (E_SOURCE/E_AUDIT/admission taxonomy), full-jitter
           retry for transient failures, one fsynced journal line per
           settled cluster, --resume replay bit-identical to an
           uninterrupted run, cancellation at cluster boundaries
  report   deterministic fleet analytics (utilization distribution, top
           rejecting filter ops, bucket sharing, quarantine summary) and
           the report digest the resume contract is tested against
"""

from open_simulator_tpu_torch.campaign.audit import (  # noqa: F401
    AuditError,
    AuditReport,
    AuditViolation,
    audit_result,
    format_audit,
)
from open_simulator_tpu_torch.campaign.fleet import (  # noqa: F401
    ClusterEntry,
    discover_fleet,
    entries_for_paths,
    fleet_digest,
    source_digest,
    write_synthetic_fleet,
)
from open_simulator_tpu_torch.campaign.report import (  # noqa: F401
    build_report,
    format_report,
    report_digest,
)
from open_simulator_tpu_torch.campaign.runner import (  # noqa: F401
    CampaignJournal,
    CampaignOptions,
    load_and_admit,
    report_from_journal,
    resolve_campaign,
    run_audit,
    run_campaign,
)
