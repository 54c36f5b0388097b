"""Per-tenant service-level objectives and the machine-readable verdict.

Port of kubedtn_tpu/slo/spec.py (unchanged).

An `SloSpec` states what a tenant was promised: a delivery-ratio floor
and latency-tail bounds (p99 / p99.9 in µs), plus the burn-rate
alerting configuration (fast/slow window sizes in telemetry windows,
warn/page thresholds). Defaults key off the tenancy QoS class — gold
tenants get tight objectives, bronze gets backfill-grade ones — so an
unconfigured plane has sensible SLOs from the first `kdt tenant
create`, and `SloEvaluator.set_spec` overrides per tenant.

An `SloVerdict` is one evaluation's machine-readable answer — the
autopilot hook: `updates.gate.Guardrails.from_slo` consumes either a
spec or a verdict directly, so the plan → gate → stage pipeline can
verify a change against "what this tenant was promised" instead of
hand-tuned thresholds.

Burn-rate semantics (the multi-window error-budget discipline): for
each objective, the error FRACTION observed over a window divided by
the budgeted error fraction (1 − floor for delivery, 1 − q for a
latency bound). Burn 1.0 = consuming budget exactly as fast as it
accrues; burn 10 = the budget for the whole horizon gone in a tenth
of it. `fast` (newest windows) catches a cliff, `slow` (the whole
ring) filters blips: severity is keyed on the SMALLER of the two, so
paging needs both to agree — the standard two-window rule.
"""

from __future__ import annotations

import dataclasses

# severity ladder (stable codes for the kubedtn_slo_severity gauge)
SEV_OK = "ok"
SEV_WARN = "warn"
SEV_PAGE = "page"
SEVERITY_LEVELS = {SEV_OK: 0, SEV_WARN: 1, SEV_PAGE: 2}


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One tenant's objectives + burn alerting configuration."""

    delivery_ratio_floor: float = 0.99   # SLO: delivered/offered ≥ this
    p99_bound_us: float = 100_000.0      # SLO: p99 shaping latency ≤ this
    p999_bound_us: float = 0.0           # 0 = no p99.9 objective
    fast_windows: int = 2                # burn window sizes, in closed
    slow_windows: int = 12               # telemetry windows
    warn_burn: float = 1.0               # severity thresholds on
    page_burn: float = 4.0               # min(fast, slow) burn

    def __post_init__(self) -> None:
        if not 0.0 < self.delivery_ratio_floor < 1.0:
            raise ValueError(
                f"delivery_ratio_floor must be in (0, 1), got "
                f"{self.delivery_ratio_floor}")
        if self.fast_windows < 1 or self.slow_windows < self.fast_windows:
            raise ValueError(
                "need 1 <= fast_windows <= slow_windows, got "
                f"{self.fast_windows}/{self.slow_windows}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SloSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def for_qos(cls, qos: str) -> "SloSpec":
        """QoS-class default objectives (overridable per tenant)."""
        return QOS_SLO_DEFAULTS.get(qos, QOS_SLO_DEFAULTS["gold"])


# QoS class → default objectives. Bounds sit on the telemetry ladder's
# scale (edges 1ms..5s): gold is a serving-grade promise, bronze a
# backfill-grade one. The ROADMAP's autopilot sentence — "keep gold
# p99 under X while bronze backfills" — is exactly the gap between
# these two rows.
QOS_SLO_DEFAULTS: dict[str, SloSpec] = {
    "gold": SloSpec(delivery_ratio_floor=0.999,
                    p99_bound_us=20_000.0, p999_bound_us=100_000.0),
    "silver": SloSpec(delivery_ratio_floor=0.99,
                      p99_bound_us=100_000.0, p999_bound_us=500_000.0),
    "bronze": SloSpec(delivery_ratio_floor=0.95,
                      p99_bound_us=1_000_000.0,
                      p999_bound_us=2_000_000.0),
}


@dataclasses.dataclass
class SloVerdict:
    """One tenant's evaluated SLO state — the machine-readable record
    the metrics collector exports, `Local.ObserveSLO` serves, and
    `Guardrails.from_slo` consumes."""

    tenant: str
    qos: str
    spec: SloSpec
    # observation (slow window span, closed windows only)
    window_seconds: float = 0.0
    tx: float = 0.0
    delivered: float = 0.0
    delivery_ratio: float | None = None
    # estimated tails (slo.tail): past-the-edge when the fit succeeds
    p50_us: float | None = None
    p99_us: float | None = None
    p99_censored: bool = False
    p999_us: float | None = None
    tail_method: str = "empty"       # how p99.9 was obtained
    # admission pressure folded into the delivery objective: frames
    # parked behind the tenant's own throttle are unserved demand
    throttle_backlog: float = 0.0
    # burn rates (max over objectives, per window)
    fast_burn: float = 0.0
    slow_burn: float = 0.0
    # error budget over the slow window: fraction remaining in [0, 1]
    budget_remaining: float = 1.0
    attainment_ok: bool = True       # delivery objective met (slow win)
    latency_ok: bool = True          # latency objective(s) met
    severity: str = SEV_OK
    # the slow-window histogram slice (shared ladder) — what the fleet
    # merge adds across planes, exactly
    hist: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.attainment_ok and self.latency_ok

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_dict()
        d["ok"] = self.ok
        return d


def severity_of(spec: SloSpec, fast_burn: float,
                slow_burn: float) -> str:
    """The two-window rule: both windows must agree before paging."""
    gate = min(fast_burn, slow_burn)
    if gate >= spec.page_burn:
        return SEV_PAGE
    if gate >= spec.warn_burn:
        return SEV_WARN
    return SEV_OK
