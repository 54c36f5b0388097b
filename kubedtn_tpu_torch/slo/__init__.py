"""SLO observability plane — per-tenant objectives, censored-tail
estimation, burn-rate error budgets, and fleet-wide aggregation.

Port of kubedtn_tpu/slo (host code over numpy, unchanged but for the
imports: the tails read the port's own telemetry.py ladder).

The measurement substrate of the ROADMAP's "SLO autopilot": turns the
telemetry plane's per-edge bucket histograms and the tenancy
registry's columnar slicing into continuously-evaluated
per-tenant SLO attainment — zero new device dispatches, zero per-frame
host work, O(tenants) per telemetry window rollover.

- `spec` — SloSpec objectives (QoS-keyed defaults) + SloVerdict.
- `tail` — log-linear censored-tail fit: p99.9/p99.99 estimated PAST
  the bucket ladder's last edge instead of clamped to it.
- `evaluator` — SloEvaluator: window-rollover-triggered evaluation,
  multi-window burn rates, error budgets, the daemon sidecar loop.
- `fleet` — exact cross-plane histogram merge, stitched with the
  migration journal's frozen window slices for continuity across
  live moves (`kdt slo --fleet`).
"""

from kubedtn_tpu_torch.slo.evaluator import (SloEvaluator, SloStats,
                                             evaluate_tenant, evaluator_for)
from kubedtn_tpu_torch.slo.fleet import (fleet_slo, merge_hists,
                                         merge_tenant)
from kubedtn_tpu_torch.slo.spec import (QOS_SLO_DEFAULTS, SEVERITY_LEVELS,
                                        SloSpec, SloVerdict)
from kubedtn_tpu_torch.slo.tail import (TailFit, estimate_quantile,
                                        fit_tail, fraction_slower_than)

__all__ = [
    "QOS_SLO_DEFAULTS", "SEVERITY_LEVELS", "SloEvaluator", "SloSpec",
    "SloStats", "SloVerdict", "TailFit", "estimate_quantile",
    "evaluate_tenant", "evaluator_for", "fit_tail", "fleet_slo",
    "fraction_slower_than", "merge_hists", "merge_tenant",
]
