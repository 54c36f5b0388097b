"""Daemon-side planned-update surface: `Local.PlanUpdate` /
`Local.ApplyPlan` (framework extensions, absent from the reference
IDL — the claim/apply shape of the Kubernetes Network Driver Model,
PAPERS.md arxiv 2506.23628).

`PlanUpdate` is the CLAIM: the client declares a topology's desired
link set; the daemon diffs it against the realized state
(status.links), builds the ordered schedule (updates.planner), forks a
consistent snapshot of the running plane, and dry-runs the schedule
through the verification gate (updates.gate). A VERIFIED plan is
parked in a bounded per-daemon registry and its id returned; a
rejected plan returns the verdict and no id — it cannot be applied.

`ApplyPlan` is the APPLY: the parked plan stages through the live
plane (updates.stager) with the same guardrails the gate used. The
realized state is re-checked against the plan's base first — a
topology that moved since planning is a CONFLICT, not a silent
mis-apply. On success both spec and status advance to the desired
links, so the next reconcile pass sees a steady topology.

Port of kubedtn_tpu/updates/service.py.
"""

from __future__ import annotations

import collections
import itertools
import threading

from kubedtn_tpu_torch.topology.store import NotFoundError, retry_on_conflict
from kubedtn_tpu_torch.twin.snapshot import snapshot_from_engine
from kubedtn_tpu_torch.updates.gate import Guardrails, verify_plan, \
    verify_plan_live
from kubedtn_tpu_torch.updates.planner import PlanError, plan_update
from kubedtn_tpu_torch.updates.stager import stats_for
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

# parked verified plans per daemon: bounded — a client that plans and
# never applies must not grow the daemon's memory
MAX_STORED_PLANS = 16

_ATTACH_LOCK = threading.Lock()
_plan_ids = itertools.count(1)


def _plan_registry(daemon):
    """(plans OrderedDict, lock) attached to the daemon on first use."""
    with _ATTACH_LOCK:
        reg = getattr(daemon, "_update_plans", None)
        if reg is None:
            reg = daemon._update_plans = (collections.OrderedDict(),
                                          threading.Lock())
        return reg


def _guardrails_from(request) -> Guardrails:
    """proto3 presence convention: 0 / 0.0 means UNSET → default."""
    d = Guardrails()
    return Guardrails(
        max_delivery_drop=float(request.max_delivery_drop)
        or d.max_delivery_drop,
        max_p99_factor=float(request.max_p99_factor) or d.max_p99_factor,
        ticks=int(request.ticks) or d.ticks,
        dt_us=float(request.dt_us) or d.dt_us,
        seed=int(request.seed))


def serve_plan_update(daemon, request):
    """The Local.PlanUpdate handler body."""
    from kubedtn_tpu_torch.wire import proto as pb

    stats = stats_for(daemon)
    log = get_logger("updates")
    try:
        name = request.name
        ns = request.kube_ns or "default"
        topo = daemon.engine.store.get(ns, name)
        if topo.status.links is None:
            raise ValueError(
                "topology not realized yet — bootstrap is a direct "
                "apply (reconcile), not a planned update")
        desired = [pb.link_from_proto(l) for l in request.links]
        for link in desired:
            link.validate()
        plan = plan_update(
            topo.status.links, desired, namespace=ns, name=name,
            max_round_edits=int(request.max_round_edits) or None)
    except (NotFoundError, PlanError, ValueError) as e:
        stats.record_plan_error()
        return pb.PlanUpdateResponse(
            ok=False, error=f"{type(e).__name__}: {e}")
    if not plan.rounds:
        # empty diff: nothing to stage, trivially verified
        return pb.PlanUpdateResponse(ok=True, plan_id=0, verified=True)
    g = _guardrails_from(request)
    try:
        plane = getattr(daemon, "dataplane", None)
        if plane is not None:
            verdict = verify_plan_live(plane, plan, guardrails=g)
        else:
            with daemon.engine._lock:
                pod_ids = dict(daemon.engine._pod_ids)
            verdict = verify_plan(plan, snapshot_from_engine(
                daemon.engine), guardrails=g, pod_ids=pod_ids)
    except Exception as e:  # a bad plan must not kill the worker
        stats.record_plan_error()
        log.warning("plan verification failed %s", _fields(
            topology=plan.key, error=f"{type(e).__name__}: {e}"))
        return pb.PlanUpdateResponse(
            ok=False, error=f"{type(e).__name__}: {e}")
    stats.record_plan(verdict)
    plan_id = 0
    if verdict.ok:
        plan_id = next(_plan_ids)
        plans, lock = _plan_registry(daemon)
        with lock:
            plans[plan_id] = (plan, g)
            while len(plans) > MAX_STORED_PLANS:
                plans.popitem(last=False)
    log.info("plan %s", _fields(
        topology=plan.key, plan_id=plan_id, rounds=plan.n_rounds,
        edits=plan.n_edits, verified=verdict.ok,
        reject_reason=verdict.reason, gate_s=verdict.gate_s))
    nn = lambda v: -1.0 if v is None else float(v)  # noqa: E731
    rounds = []
    for i, rnd in enumerate(plan.rounds):
        gr = verdict.rounds[i] if i < len(verdict.rounds) else {}
        rounds.append(pb.PlanRound(
            index=rnd.index, adds=len(rnd.adds),
            changes=len(rnd.changes), dels=len(rnd.dels),
            delivery_ratio=nn(gr.get("delivery_ratio")),
            p99_us=nn(gr.get("p99_us"))))
    return pb.PlanUpdateResponse(
        ok=True, plan_id=plan_id, rounds=rounds, verified=verdict.ok,
        reject_reason=verdict.reason,
        baseline_delivery_ratio=nn(verdict.baseline.get(
            "delivery_ratio")),
        baseline_p99_us=nn(verdict.baseline.get("p99_us")),
        gate_s=verdict.gate_s, skipped_adds=verdict.skipped_adds)


def serve_apply_plan(daemon, request):
    """The Local.ApplyPlan handler body."""
    from kubedtn_tpu_torch.wire import proto as pb

    stats = stats_for(daemon)
    plans, lock = _plan_registry(daemon)
    with lock:
        entry = plans.pop(int(request.plan_id), None)
    if entry is None:
        return pb.ApplyPlanResponse(
            ok=False, error=f"unknown or expired plan id "
                            f"{int(request.plan_id)} (re-plan)")
    plan, g = entry
    plane = getattr(daemon, "dataplane", None)
    if plane is None:
        return pb.ApplyPlanResponse(
            ok=False, error="no live data plane attached to this daemon")
    from kubedtn_tpu_torch.updates.stager import StagingBusyError

    try:
        topo = daemon.engine.store.get(plan.namespace, plan.name)
    except NotFoundError:
        return pb.ApplyPlanResponse(
            ok=False, error=f"topology {plan.key} no longer exists")
    if list(topo.status.links or []) != list(plan.old_links):
        return pb.ApplyPlanResponse(
            ok=False, error=f"conflict: topology {plan.key} changed "
                            f"since the plan was built (re-plan)")
    try:
        stager = plane.update_stager(stats=stats)
        result = stager.stage(
            plan, topo,
            observe_ticks=int(request.observe_ticks) or 2,
            guardrails=g)
    except StagingBusyError as e:
        # transient (another staging in progress): the plan is still
        # valid — re-park it so a retry of the SAME id works instead of
        # forcing a full re-plan (bounded registry may evict it)
        with lock:
            plans.setdefault(int(request.plan_id), entry)
            while len(plans) > MAX_STORED_PLANS:
                plans.popitem(last=False)
        return pb.ApplyPlanResponse(
            ok=False, error=f"{type(e).__name__}: {e}")
    except Exception as e:
        # a real staging failure (the stager already rolled back): the
        # plan is consumed — repeated retries of a deterministically
        # failing id would re-fail; re-plan instead
        get_logger("updates").exception(
            "apply-plan failed %s", _fields(topology=plan.key))
        return pb.ApplyPlanResponse(
            ok=False, error=f"{type(e).__name__}: {e}")
    if result.ok:
        def txn():
            try:
                fresh = daemon.engine.store.get(plan.namespace,
                                                plan.name)
            except NotFoundError:
                return
            # advance the SPEC only while it still reflects the plan's
            # old or new links: a newer desired state posted after the
            # plan was built must not be clobbered — status records
            # what was realized, and the next reconcile converges the
            # plane toward the newer spec
            if fresh.spec.links in (list(plan.old_links),
                                    list(plan.new_links)):
                fresh.spec.links = list(plan.new_links)
                daemon.engine.store.update(fresh)
                fresh = daemon.engine.store.get(plan.namespace,
                                                plan.name)
            else:
                get_logger("updates").warning(
                    "apply-plan: spec moved since planning %s",
                    _fields(topology=plan.key,
                            note="status advanced; newer spec left "
                                 "for reconcile"))
            fresh.status.links = list(plan.new_links)
            daemon.engine.store.update_status(fresh)

        retry_on_conflict(txn)
    return pb.ApplyPlanResponse(
        ok=result.ok, error="",
        rounds_applied=result.rounds_applied,
        rolled_back=result.rolled_back, reason=result.reason,
        stage_s=result.stage_s)
