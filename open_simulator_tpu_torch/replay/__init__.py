"""Time-stepped scenario programs on the port's engine: trace replay,
controller loops and cost-aware capacity frontiers (the reference's
``replay/``).

Public surface:

* ``ReplayTrace`` / ``TraceEvent`` — the timed event model (trace.py)
* ``run_replay`` / ``ReplayOptions`` — the closed loop over the scan,
  with journal checkpoint/resume (engine.py)
* ``AutoscalerPolicy`` / ``DeschedulerPolicy`` — step controllers
  (controllers.py)
* ``capacity_frontier`` / ``NodeSpec`` / ``pareto_set`` — heterogeneous
  mix sweeps (frontier.py)

The digital-twin sessions (``replay/session.py``) are ROADMAP queue 1,
item 11.
"""

from open_simulator_tpu_torch.replay.controllers import (  # noqa: F401
    AutoscalerPolicy,
    DeschedulerPolicy,
    StepView,
    controller_from_arg,
    controller_from_dict,
)
from open_simulator_tpu_torch.replay.engine import (  # noqa: F401
    ReplayJournal,
    ReplayOptions,
    report_from_journal,
    resolve_replay,
    rows_digest,
    run_replay,
)
from open_simulator_tpu_torch.replay.frontier import (  # noqa: F401
    NodeSpec,
    capacity_frontier,
    dominates,
    enumerate_mixes,
    format_frontier,
    pareto_set,
    parse_specs,
)
from open_simulator_tpu_torch.replay.report import (  # noqa: F401
    build_report,
    format_report,
)
from open_simulator_tpu_torch.replay.synthetic import (  # noqa: F401
    synthetic_frontier_specs,
    synthetic_replay_cluster,
    synthetic_trace_dict,
)
from open_simulator_tpu_torch.replay.trace import (  # noqa: F401
    ReplayTrace,
    TraceEvent,
)
