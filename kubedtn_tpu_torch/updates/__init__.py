"""Planned-update engine: twin-verified consistent topology changes
with automatic rollback.

The reconciler's direct path applies a topology delta straight onto
the live plane; this package turns a delta into a production change
gate (ROADMAP "Consistent-update scheduler"):

- `planner` — `calc_diff` output → ordered multi-round schedule
  (make-before-break, per "The Augmentation-Speed Tradeoff for
  Consistent Network Updates", arxiv 2211.03716) with a static
  loop/blackhole check over every intermediate topology;
- `gate` — dry-run the schedule as ONE cumulative what-if sweep
  against a live snapshot (twin/), rejecting plans that regress
  delivery ratio or p99 beyond the guardrails;
- `stager` — land approved rounds through the running WireDataPlane
  at flush barriers, watch the telemetry window ring between rounds,
  and roll back bit-exactly through the row-level journal on
  regression or dispatch failure;
- `service` — the `Local.PlanUpdate` / `Local.ApplyPlan` wire surface.

Port of kubedtn_tpu/updates.
"""

from kubedtn_tpu_torch.updates.gate import (
    GateVerdict,
    Guardrails,
    verify_plan,
    verify_plan_live,
)
from kubedtn_tpu_torch.updates.planner import (
    PlanError,
    UpdatePlan,
    UpdateRound,
    check_plan,
    inverse_round,
    plan_update,
)
from kubedtn_tpu_torch.updates.stager import (
    StageResult,
    StagingBusyError,
    UpdateStager,
    UpdateStats,
    stats_for,
)

__all__ = [
    "GateVerdict", "Guardrails", "verify_plan", "verify_plan_live",
    "PlanError", "UpdatePlan", "UpdateRound", "check_plan",
    "inverse_round", "plan_update",
    "StageResult", "StagingBusyError", "UpdateStager", "UpdateStats",
    "stats_for",
]
