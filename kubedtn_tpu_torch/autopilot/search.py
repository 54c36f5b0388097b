"""Grid scoring — ONE batched twin sweep, ranked by projected burn.

Port of kubedtn_tpu/autopilot/search.py. The sweep is the port's
`twin.run_sweep`: every shaping slot of a step is one launch of kernel
K1 over (1 + candidates) x E replica rows on the card. Its draws come
from `seed` through the port's Philox schedule, not JAX's threefry, so
a ranking equals JAX's only on JAX's own draws, which `draws=` hands
to the sweep (tests only, as run_sweep's). `compile_s` is the kernels'
build and load at their first use in the sweep (no executable cache).

The whole grid (baseline replica + one replica per candidate) runs as
a single compiled sweep over the tenant's snapshot fork
(`tenancy.registry.tenant_snapshot`: foreign rows deactivated, so a
candidate can only be scored against the tenant's own edges). Each
replica's counters are folded into a synthetic telemetry row and fed
to the SAME pure verdict core the live evaluator uses
(`slo.evaluator.evaluate_tenant`) — the autopilot ranks candidates by
the very arithmetic that paged, not by a proxy metric.

Parked admission backlog is charged per candidate (`parked_mode`):
shape/reroute keep the observed backlog, a quota trim ADDS the demand
it sheds (baseline tx − candidate tx), a drain boost clears it. That
keeps quota trims honest — shedding load always flatters the delivery
ratio, but the shed frames are still unserved demand under the SLO's
own definition.

The winner is the lowest projected burn (ties break toward the least
invasive candidate, then the name — a total, deterministic order);
`SearchResult.winner` is None when nothing strictly improves on the
baseline replica, which the controller records as a no-candidate
action instead of staging churn.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from kubedtn_tpu_torch import telemetry as tele
from kubedtn_tpu_torch.autopilot.candidates import (
    PARKED_ADD_SHED,
    PARKED_CLEAR,
)
from kubedtn_tpu_torch.slo.evaluator import evaluate_tenant
from kubedtn_tpu_torch.twin import Scenario, run_sweep

BASELINE = "baseline"


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    """One candidate's projected outcome."""

    candidate: object            # the Candidate scored
    projected_burn: float        # slow-window burn of the replica
    delivery_ratio: float | None
    p99_us: float | None
    parked: float                # backlog charged to this replica


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """One search: the ranked grid plus sweep provenance."""

    tenant: str
    baseline_burn: float
    ranked: tuple                # ScoredCandidate, best first
    winner: object | None        # Candidate, or None (no improvement)
    candidates: int
    replicas: int
    ticks: int
    sim_seconds: float
    compile_s: float             # 0.0 on a warm executable cache
    run_s: float
    seed: int


def _telemetry_row(metrics: dict) -> np.ndarray:
    """A replica's counters as one [KCOLS] window slice — the shape
    `_burns`/`evaluate_tenant` reduce (twin and telemetry share the
    bucket ladder, so the histogram maps 1:1)."""
    row = np.zeros(tele.KCOLS, np.float64)
    row[tele.T_TX] = float(metrics.get("tx_packets") or 0.0)
    row[tele.T_DELIVERED] = float(metrics.get("delivered_packets")
                                  or 0.0)
    row[tele.T_DROP_LOSS] = float(metrics.get("dropped_loss") or 0.0)
    row[tele.T_DROP_QUEUE] = float(metrics.get("dropped_queue") or 0.0)
    hist = metrics.get("latency_hist") or ()
    n = min(len(hist), tele.N_BINS)
    row[tele.T_HIST0:tele.T_HIST0 + n] = np.asarray(hist[:n],
                                                    np.float64)
    return row


def _projected(tenant: str, qos: str, spec, metrics: dict,
               seconds: float, parked: float):
    """One replica's verdict under the tenant's own SloSpec (fast and
    slow windows collapse to the same sweep-horizon slice)."""
    row = _telemetry_row(metrics)
    return evaluate_tenant(tenant, qos, spec, row, seconds, row,
                           parked=parked)


def score_candidates(snapshot, tenant: str, qos: str, spec,
                     candidates, *, verdict=None, steps: int = 400,
                     dt_us: float = 1000.0, seed: int = 0,
                     k_slots: int = 4, traffic=None, mesh=None,
                     pod_ids=None, draws=None) -> SearchResult:
    """Score `candidates` against `snapshot` as ONE compiled sweep.

    `verdict` supplies the observed parked backlog (its
    `throttle_backlog`); `traffic` overrides the sweep's offered load
    (defaults to the query surface's CBR spec). O(grid) host work
    around one device sweep — the compile/run split lands in the
    result so the bench can pin the cheap-by-construction claim.
    `draws` (one sim.StepDraws per step) replaces the seeded draws, as
    in run_sweep.
    """
    cands = list(candidates)
    scenarios = [Scenario(BASELINE, ())]
    scenarios += [c.scenario() for c in cands]
    res = run_sweep(snapshot, scenarios, steps=int(steps),
                    dt_us=float(dt_us), spec=traffic,
                    k_slots=int(k_slots), seed=int(seed), mesh=mesh,
                    pod_ids=pod_ids, draws=draws)
    seconds = res.sim_seconds
    parked_base = float(getattr(verdict, "throttle_backlog", 0.0)
                        or 0.0)
    base_m = res.metrics[0]
    base_tx = float(base_m.get("tx_packets") or 0.0)
    baseline_burn = _projected(tenant, qos, spec, base_m, seconds,
                               parked_base).slow_burn

    scored = []
    for i, c in enumerate(cands):
        m = res.metrics[i + 1]
        if c.parked_mode == PARKED_CLEAR:
            parked = 0.0
        elif c.parked_mode == PARKED_ADD_SHED:
            shed = max(0.0, base_tx - float(m.get("tx_packets")
                                            or 0.0))
            parked = parked_base + shed
        else:
            parked = parked_base
        v = _projected(tenant, qos, spec, m, seconds, parked)
        scored.append(ScoredCandidate(
            candidate=c, projected_burn=v.slow_burn,
            delivery_ratio=v.delivery_ratio, p99_us=v.p99_us,
            parked=parked))
    ranked = tuple(sorted(
        scored, key=lambda s: (round(s.projected_burn, 9),
                               s.candidate.cost, s.candidate.name)))
    winner = None
    if ranked and ranked[0].projected_burn < baseline_burn - 1e-9:
        winner = ranked[0].candidate
    return SearchResult(
        tenant=tenant, baseline_burn=baseline_burn, ranked=ranked,
        winner=winner, candidates=len(cands), replicas=res.replicas,
        ticks=res.ticks, sim_seconds=seconds,
        compile_s=res.compile_s, run_s=res.run_s, seed=int(seed))
