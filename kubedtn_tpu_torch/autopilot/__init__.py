"""SLO autopilot — the closed loop from burn-rate page to twin-gated
staged remediation.

Port of kubedtn_tpu/autopilot (host code; its device work is the twin's
sweeps, each shaping slot one launch of kernel K1 over all replica
rows).

candidates: the deterministic gradient-free search grid (shaping /
            reroute / quota / drain), in the twin's `Perturbation`
            vocabulary.
search:     ONE batched sweep over the tenant's snapshot fork, ranked
            by projected burn against the tenant's own `SloSpec`.
actuator:   winner → plan → gate (`Guardrails.from_slo`) → stage
            (live-watch + row-journal rollback), or the admission
            plane for quota/drain moves.
controller: the observe → search → stage → verify → hold state
            machine, sidecar thread, history ring, stats, and the
            fleet-rebalance escalation tier.
"""

from kubedtn_tpu_torch.autopilot.actuator import (
    ActionOutcome,
    PlanOutcome,
    actuate,
)
from kubedtn_tpu_torch.autopilot.candidates import Candidate, candidate_grid
from kubedtn_tpu_torch.autopilot.controller import (
    Autopilot,
    AutopilotConfig,
    AutopilotStats,
    autopilot_for,
)
from kubedtn_tpu_torch.autopilot.search import (
    ScoredCandidate,
    SearchResult,
    score_candidates,
)

__all__ = [
    "ActionOutcome",
    "Autopilot",
    "AutopilotConfig",
    "AutopilotStats",
    "Candidate",
    "PlanOutcome",
    "ScoredCandidate",
    "SearchResult",
    "actuate",
    "autopilot_for",
    "candidate_grid",
    "score_candidates",
]
