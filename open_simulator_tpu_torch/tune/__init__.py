"""Policy tuning on the lane axis: traced score weights, the grid and
CEM-style Pareto searches, W policy variants as the lanes of one launch
(the reference's ``tune/``)."""

from open_simulator_tpu_torch.tune.search import (  # noqa: F401
    DEFAULT_GRID_VALUES,
    TUNE_OBJECTIVES,
    TuneOptions,
    brute_force_pareto,
    format_tune,
    pareto_points,
    tune_search,
)
