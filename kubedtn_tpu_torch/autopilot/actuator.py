"""Actuation — the winning candidate through plan → gate → stage.

Port of kubedtn_tpu/autopilot/actuator.py (unchanged). Each plan's gate
is one 2-lane twin sweep of the whole snapshot (`verify_plan_live`), so
the gate's cost grows with the topologies a candidate touches.

A shape/reroute winner becomes per-topology `UpdatePlan`s over the
tenant's OWN topologies (the same `LinkProperties` the twin scored —
no translation between the replica that won and the delta that
ships). Every plan is gated FIRST (`verify_plan_live` with
`Guardrails.from_slo` thresholds: the tenant's promised floor, scaled
by its remaining error budget) and staged only when EVERY plan
passes — a gate-REJECTED candidate therefore leaves the plane
byte-identical to pre-page, which the acceptance test pins against
the engine's SoA columns. Staging rides the planned-update stager: live-watch
between rounds, row-journal rollback on regression — every autopilot
action is bit-exact reversible by construction.

A quota/drain winner is an admission-plane action
(`TenantRegistry.set_quota`); the pre-action values land in the
outcome so the operator (and the history ring) can audit and revert.

`dry_run` runs the gate and computes the full outcome but stages
nothing and mutates nothing — the "show me what you would do" mode.
"""

from __future__ import annotations

import dataclasses

from kubedtn_tpu_torch.autopilot.candidates import QOS_PROMOTION
from kubedtn_tpu_torch.updates import (Guardrails, plan_update,
                                       verify_plan_live)
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

log = get_logger("autopilot")


@dataclasses.dataclass(frozen=True)
class PlanOutcome:
    """One topology's trip through the gate (and maybe the stager)."""

    namespace: str
    name: str
    gate_ok: bool
    gate_reason: str = ""
    staged: bool = False
    rolled_back: bool = False
    rounds: int = 0
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class ActionOutcome:
    """The whole action: every plan's outcome plus the quota record."""

    ok: bool
    kind: str
    staged: bool = False
    rejected: bool = False
    rolled_back: bool = False
    dry_run: bool = False
    reason: str = ""
    plans: tuple = ()            # PlanOutcome per gated topology
    quota_before: dict | None = None   # quota/drain: pre-action values
    quota_after: dict | None = None
    gate_s: float = 0.0
    stage_s: float = 0.0


def _copy_back_status(store, plan) -> None:
    """Record a committed stage in the topology's status — the same
    copy-back the reconciler does after a planned update, so the next
    search reads the remediated properties, not the paged ones."""
    from kubedtn_tpu_torch.topology.store import (NotFoundError,
                                                  retry_on_conflict)

    def txn() -> None:
        try:
            fresh = store.get(plan.namespace, plan.name)
        except NotFoundError:
            return
        fresh.status.links = list(plan.new_links)
        store.update_status(fresh)

    retry_on_conflict(txn)


def _tenant_topologies(engine, registry, tenant: str) -> list:
    """The tenant's topologies, in a stable (namespace, name) order."""
    t = registry.get(tenant)
    if t is None:
        return []
    topos = []
    for ns in sorted(t.namespaces):
        topos.extend(engine.store.list(ns))
    return sorted(topos, key=lambda tp: (tp.namespace, tp.name))


def _shape_plans(engine, registry, tenant: str, candidate) -> list:
    """(topology, plan) per tenant topology the candidate touches."""
    props_map = dict(candidate.props_by_uid)
    fail = set(candidate.fail_uids)
    out = []
    for topo in _tenant_topologies(engine, registry, tenant):
        old = list(topo.status.links)
        new = []
        touched = False
        for link in old:
            if link.uid in fail:
                touched = True
                continue  # omitted => a DEL round (next-hop move)
            p = props_map.get(link.uid)
            if p is not None and p != link.properties:
                new.append(link.with_properties(p))
                touched = True
            else:
                new.append(link)
        if not touched:
            continue
        plan = plan_update(old, new, namespace=topo.namespace,
                           name=topo.name)
        if plan.rounds:
            out.append((topo, plan))
    return out


def actuate(plane, registry, tenant: str, candidate, slo, *,
            guardrails: Guardrails | None = None, overrides=(),
            observe_ticks: int = 2, tick_driver=None,
            dry_run: bool = False) -> ActionOutcome:
    """Drive `candidate` through gate → stage (shape/reroute) or the
    admission plane (quota/drain). `slo` is the paging SloVerdict (or
    a bare SloSpec) that sets the gate thresholds; `overrides` are
    (key, value) pairs passed through to `Guardrails.from_slo`.
    """
    if candidate.kind in ("quota", "drain"):
        return _actuate_admission(registry, tenant, candidate, slo,
                                  dry_run=dry_run)
    g = guardrails or Guardrails.from_slo(slo, **dict(overrides))
    engine = plane.engine
    pairs = _shape_plans(engine, registry, tenant, candidate)
    if not pairs:
        return ActionOutcome(ok=False, kind=candidate.kind,
                             rejected=True, dry_run=dry_run,
                             reason="no plan: candidate touches no "
                                    "tenant topology")
    # gate EVERY plan before staging ANY: a single rejection aborts
    # the whole delta with the plane untouched
    outcomes = []
    gate_s = 0.0
    rejected = None
    for topo, plan in pairs:
        gv = verify_plan_live(plane, plan, guardrails=g)
        gate_s += gv.gate_s
        outcomes.append([topo, plan, gv])
        if not gv.ok and rejected is None:
            rejected = f"{plan.key}: {gv.reason}"
    if rejected is not None:
        plans = tuple(PlanOutcome(
            namespace=p.namespace, name=p.name, gate_ok=v.ok,
            gate_reason=v.reason) for _t, p, v in outcomes)
        log.info("autopilot gate rejected %s", _fields(
            tenant=tenant, candidate=candidate.name, reason=rejected))
        return ActionOutcome(ok=False, kind=candidate.kind,
                             rejected=True, dry_run=dry_run,
                             reason=rejected, plans=plans,
                             gate_s=gate_s)
    if dry_run:
        plans = tuple(PlanOutcome(
            namespace=p.namespace, name=p.name, gate_ok=True,
            gate_reason=v.reason, reason="dry-run: not staged")
            for _t, p, v in outcomes)
        return ActionOutcome(ok=True, kind=candidate.kind,
                             dry_run=True, reason="dry-run",
                             plans=plans, gate_s=gate_s)
    plans = []
    stage_s = 0.0
    rolled_back = False
    reason = ""
    for topo, plan, gv in outcomes:
        res = plane.update_stager().stage(
            plan, topo, observe_ticks=observe_ticks,
            tick_driver=tick_driver, guardrails=g)
        stage_s += res.stage_s
        plans.append(PlanOutcome(
            namespace=plan.namespace, name=plan.name, gate_ok=True,
            gate_reason=gv.reason, staged=res.ok,
            rolled_back=res.rolled_back, rounds=res.rounds_applied,
            reason=res.reason))
        if not res.ok:
            rolled_back = rolled_back or res.rolled_back
            reason = f"{plan.key}: {res.reason}"
            break  # stop escalating a delta the watch already refused
        _copy_back_status(engine.store, plan)
    ok = all(p.staged for p in plans) and len(plans) == len(outcomes)
    return ActionOutcome(ok=ok, kind=candidate.kind, staged=ok,
                         rolled_back=rolled_back,
                         reason=reason or "staged",
                         plans=tuple(plans), gate_s=gate_s,
                         stage_s=stage_s)


def _actuate_admission(registry, tenant: str, candidate, slo, *,
                       dry_run: bool = False) -> ActionOutcome:
    """Quota trim / drain-weight boost on the admission plane."""
    t = registry.get(tenant)
    if t is None:
        return ActionOutcome(ok=False, kind=candidate.kind,
                             rejected=True, dry_run=dry_run,
                             reason=f"unknown tenant {tenant!r}")
    before = {"qos": t.qos,
              "frame_budget_per_s": t.frame_budget_per_s}
    if candidate.kind == "drain":
        promoted = QOS_PROMOTION.get(t.qos)
        if promoted is None:
            return ActionOutcome(ok=False, kind=candidate.kind,
                                 rejected=True, dry_run=dry_run,
                                 reason=f"{tenant}: already at the top "
                                        f"drain class ({t.qos})",
                                 quota_before=before)
        after = {"qos": promoted,
                 "frame_budget_per_s": t.frame_budget_per_s}
        if not dry_run:
            registry.set_quota(tenant, qos=promoted)
    else:
        old = t.frame_budget_per_s
        if old <= 0.0:
            # unlimited: derive the trim base from observed demand
            win = float(getattr(slo, "window_seconds", 0.0) or 0.0)
            tx = float(getattr(slo, "tx", 0.0) or 0.0)
            if win <= 0.0 or tx <= 0.0:
                return ActionOutcome(
                    ok=False, kind=candidate.kind, rejected=True,
                    dry_run=dry_run, quota_before=before,
                    reason=f"{tenant}: unlimited budget and no "
                           f"observed demand to derive a trim from")
            old = tx / win
        new = max(1.0, old * candidate.factor)
        after = {"qos": t.qos, "frame_budget_per_s": new}
        if not dry_run:
            registry.set_quota(tenant, frame_budget_per_s=new)
    return ActionOutcome(ok=True, kind=candidate.kind,
                         staged=not dry_run, dry_run=dry_run,
                         reason="dry-run" if dry_run else "applied",
                         quota_before=before, quota_after=after)
