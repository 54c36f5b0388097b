"""Topology reconciler — the controller equivalent.

Reproduces the reference controller's reconcile contract
(reference controllers/topology_controller.go:61-156) against the in-process
store and the SimEngine:

- no-op when status.links already equals spec.links (:77-79);
- first-seen rule: status.links == None means the CNI path did the initial
  plumbing, so only copy spec → status (:81-85);
- otherwise diff status vs spec into (add, del, properties-changed) sets and
  push them to the engine as DelLinks → AddLinks → UpdateLinks (:88-119);
- finally copy spec → status under RetryOnConflict, because the CNI/daemon
  path also writes status (:124-138).

Differences by design: CalcDiff is O(n) over a hash of the
8-field link identity instead of the reference's O(n²) double loop
(:288-318), and reconciles are batched-serial — batching into single device
scatters replaces the reference's 32 concurrent reconcile workers (:336) as
the scaling mechanism.

Port of kubedtn_tpu/topology/reconciler.py, the twin-gated planned
branch (kubedtn_tpu_torch.updates) included; the tracing span around
each pass comes with the port's tracing module.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from kubedtn_tpu_torch.api.types import Link
from kubedtn_tpu_torch.topology.engine import SimEngine
from kubedtn_tpu_torch.topology.store import (
    NotFoundError,
    TopologyStore,
    retry_on_conflict,
)
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger


def _identity(link: Link) -> tuple:
    """The 8-field link identity of EqualWithoutProperties
    (reference controllers/topology_controller.go:342-351)."""
    return (
        link.local_intf, link.local_ip, link.local_mac,
        link.peer_intf, link.peer_ip, link.peer_mac,
        link.peer_pod, link.uid,
    )


def calc_diff(old: list[Link], new: list[Link]):
    """O(n) diff: returns (add, delete, properties_changed).

    Same outputs as the reference's CalcDiff (topology_controller.go:288-318)
    computed via hash join instead of the nested scan. Identities are built
    once per link per call — at 100k-link drains the repeated tuple packing
    was itself a profile line. The two degenerate cases (first realize:
    nothing applied yet; teardown: empty spec) skip identity building
    entirely — at 1M links the realize drain otherwise spends ~15% of its
    time packing tuples whose only consumer would say "add everything".
    """
    if not old:
        return list(new), [], []
    if not new:
        return [], list(old), []
    old_ids = [_identity(l) for l in old]
    new_ids = [_identity(l) for l in new]
    old_by_id = dict(zip(old_ids, old))
    new_seen = set(new_ids)
    add: list[Link] = []
    changed: list[Link] = []
    for ident, link in zip(new_ids, new):
        prev = old_by_id.get(ident)
        if prev is None:
            add.append(link)
        elif prev.properties != link.properties:
            changed.append(link)
    delete = [l for i, l in zip(old_ids, old) if i not in new_seen]
    return add, delete, changed


class WorkQueue:
    """client-go-style rate-unlimited workqueue: the dedup discipline that
    lets the reference run 32 concurrent reconcile workers safely
    (reference controllers/topology_controller.go:336 sets
    MaxConcurrentReconciles; the queue semantics are client-go
    util/workqueue's dirty/processing sets).

    Invariants (re-derived, not translated):
    - a key is never handed to two workers at once (per-topology ordering);
    - add() of a key currently being processed marks it dirty, and done()
      re-queues it — an update arriving mid-reconcile is never lost;
    - add() of a key already queued is a no-op (dedup/coalescing).
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._queue: list = []          # FIFO of keys ready for a worker
        self._dirty: set = set()        # keys needing (re)processing
        self._processing: set = set()   # keys a worker holds right now
        self._shutdown = False

    def add(self, key) -> None:
        with self._cond:
            if self._shutdown or key in self._dirty:
                return
            self._dirty.add(key)
            if key in self._processing:
                return  # done() will re-queue it
            self._queue.append(key)
            self._cond.notify()

    def get(self, timeout: float | None = None):
        """Blocking take; returns None on shutdown or timeout."""
        with self._cond:
            while not self._queue and not self._shutdown:
                if not self._cond.wait(timeout):
                    return None
            if not self._queue:
                return None
            key = self._queue.pop(0)
            self._processing.add(key)
            self._dirty.discard(key)
            return key

    def done(self, key) -> None:
        with self._cond:
            self._processing.discard(key)
            if key in self._dirty and not self._shutdown:
                self._queue.append(key)
                self._cond.notify()

    def idle(self) -> bool:
        with self._cond:
            return not self._queue and not self._processing \
                and not self._dirty

    def shut_down(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()


@dataclass
class ReconcileResult:
    key: str
    # "noop" | "first-seen" | "changed" | "deleted", and on the planned
    # branch "planned" | "plan-rejected" | "plan-rolled-back" |
    # "plan-busy" | "plan-failed"
    action: str
    added: int = 0
    deleted: int = 0
    updated: int = 0
    # False ⇔ an engine op reported failure (e.g. a cross-node completion
    # RPC); status is NOT copied in that case, so the next pass re-diffs
    # and retries — the reference returns the error to controller-runtime
    # for requeue (topology_controller.go:120-122)
    ok: bool = True
    # False ⇔ the failure is a deterministic VERDICT (the twin gate
    # rejected the plan), not a transient error: drain must not requeue
    # it — retrying re-rejects forever
    retryable: bool = True
    phase_ms: dict[str, float] = field(default_factory=dict)


class Reconciler:
    """Cluster-level reconcile loop over the TopologyStore.

    With `planned=True` and a live data plane attached, topology DELTAS
    (action "changed" on an already-realized topology) route through the
    planned-update engine (kubedtn_tpu_torch.updates): ordered rounds,
    twin verification gate, staged apply with rollback. Direct apply
    (DelLinks → AddLinks → UpdateLinks) remains the bootstrap path
    (first-seen), the fallback when the planner infrastructure errors,
    and the default (`planned=False`). A plan the GATE rejects is a
    policy verdict, not a transient failure: status stays stale, the
    result carries action "plan-rejected", and the key is NOT requeued
    (retrying a deterministic rejection forever would spin); a
    mid-staging ROLLBACK requeues like any transient failure.
    """

    def __init__(self, store: TopologyStore, engine: SimEngine,
                 plane=None, planned: bool = False, guardrails=None,
                 observe_ticks: int = 2, update_stats=None) -> None:
        self.store = store
        self.engine = engine
        self.plane = plane
        self.planned = bool(planned)
        self.guardrails = guardrails
        self.observe_ticks = observe_ticks
        self.update_stats = update_stats
        self._watch = store.watch()
        # keys whose last reconcile failed, retried on the next drain pass
        # (controller-runtime's requeue-on-error)
        self._requeue: set[tuple[str, str]] = set()
        # controller-side structured logs (the reference controller logs
        # through zap, main.go:61-78)
        self.log = get_logger("reconciler")

    def reconcile(self, namespace: str, name: str) -> ReconcileResult:
        """One reconcile pass for one Topology, mirroring Reconcile
        (topology_controller.go:61-156)."""
        key = f"{namespace or 'default'}/{name}"
        t_start = time.perf_counter()
        tenancy = getattr(self.engine, "tenancy", None)
        if tenancy is not None:
            # namespace → tenant mapping: every reconciled topology is
            # attributable to a tenant from its first link (an unmapped
            # namespace auto-registers a default-QoS unlimited tenant)
            tenancy.ensure_namespace(namespace or "default")
        try:
            topo = self.store.get(namespace, name)
        except NotFoundError:
            return ReconcileResult(key=key, action="deleted")

        if topo.status.links == topo.spec.links:
            return ReconcileResult(key=key, action="noop")

        result = ReconcileResult(key=key, action="changed")
        if topo.status.links is None:
            # First sight of this topology: assume the CNI/setup path has
            # plumbed the initial links; just copy them to status below.
            result.action = "first-seen"
        else:
            add, delete, changed = calc_diff(topo.status.links,
                                             topo.spec.links)
            result.added = len(add)
            result.deleted = len(delete)
            result.updated = len(changed)
            handled = False
            if self.planned and self.plane is not None:
                handled = self._reconcile_planned(
                    topo, key, result, diff=(add, delete, changed))
                if handled and result.action == "plan-rejected":
                    # a deterministic gate verdict: surface it, leave
                    # status stale, do NOT requeue (see class docstring)
                    result.phase_ms["total"] = (
                        time.perf_counter() - t_start) * 1e3
                    return result
            if not handled:
                failed: dict[str, list[int]] = {}
                t0 = time.perf_counter()
                if not self.engine.del_links(topo, delete):
                    failed["del"] = [l.uid for l in delete]
                result.phase_ms["del"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                if not self.engine.add_links(topo, add):
                    failed["add"] = [l.uid for l in add]
                result.phase_ms["add"] = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                if not self.engine.update_links(topo, changed):
                    failed["update"] = [l.uid for l in changed]
                result.phase_ms["update"] = (
                    time.perf_counter() - t0) * 1e3
                if failed:
                    result.ok = False
                    # partial apply: some phases landed, this one did
                    # not — name the failed link set so the half-applied
                    # delta is diagnosable, not just a boolean
                    self.log.warning("reconcile partial apply %s",
                                     _fields(topology=key,
                                             failed_links=failed))

        if not result.ok:
            # Engine failure (e.g. the peer daemon rejected a cross-node
            # completion): leave status stale so the link is NOT recorded
            # as realized — the next pass re-diffs and retries, exactly
            # like controller-runtime requeueing on a returned error
            # (reference topology_controller.go:120-122). Copying status
            # here would declare a half-realized link done forever.
            # Requeue HERE, not only in drain's result loop: direct
            # reconcile()/reconcile_all() callers (startup resync) must
            # also get the retry, or a half-applied delta sits unfixed
            # until the next unrelated watch event.
            self._requeue.add((namespace, name))
            result.phase_ms["total"] = (time.perf_counter() - t_start) * 1e3
            self.log.warning("reconcile failed %s", _fields(
                topology=key, action=result.action, added=result.added,
                deleted=result.deleted, updated=result.updated,
                requeue=True))
            return result

        t0 = time.perf_counter()

        def txn():
            try:
                fresh = self.store.get(namespace, name)
            except NotFoundError:
                return
            fresh.status.links = list(topo.spec.links)
            self.store.update_status(fresh)

        retry_on_conflict(txn)
        result.phase_ms["retry"] = (time.perf_counter() - t0) * 1e3
        result.phase_ms["total"] = (time.perf_counter() - t_start) * 1e3
        if result.action != "noop":
            self.log.debug("reconcile %s", _fields(
                topology=key, action=result.action, added=result.added,
                deleted=result.deleted, updated=result.updated,
                ms=round(result.phase_ms["total"], 2)))
        return result

    def _reconcile_planned(self, topo, key: str,
                           result: ReconcileResult,
                           diff=None) -> bool:
        """Route one delta through the planned-update engine. Returns
        True when handled (result carries the verdict: action
        "planned" on success, "plan-rejected" on a gate veto,
        "plan-rolled-back" on a staging rollback); False to fall back
        to the direct path (planner infrastructure error — the delta
        must still land)."""
        from kubedtn_tpu_torch.updates import (PlanError, plan_update,
                                               verify_plan_live)

        t0 = time.perf_counter()
        try:
            plan = plan_update(topo.status.links, topo.spec.links,
                               namespace=topo.namespace, name=topo.name,
                               diff=diff)
        except PlanError:
            self.log.exception("planner failed; direct apply %s",
                               _fields(topology=key))
            if self.update_stats is not None:
                self.update_stats.record_plan_error()
            return False
        if not plan.rounds:
            return True  # empty diff (identity-only churn): nothing to do
        try:
            verdict = verify_plan_live(self.plane, plan,
                                       guardrails=self.guardrails)
        except Exception:
            # gate infrastructure failure (not a verdict): the delta
            # must still land — fall back to the direct path, loudly
            self.log.exception("update gate failed; direct apply %s",
                               _fields(topology=key))
            if self.update_stats is not None:
                self.update_stats.record_plan_error()
            return False
        if self.update_stats is not None:
            self.update_stats.record_plan(verdict)
        result.phase_ms["gate"] = (time.perf_counter() - t0) * 1e3
        if not verdict.ok:
            result.ok = False
            result.retryable = False
            result.action = "plan-rejected"
            self.log.warning("plan rejected by twin gate %s", _fields(
                topology=key, reason=verdict.reason,
                gate_ms=round(verdict.gate_s * 1e3, 1)))
            return True
        t0 = time.perf_counter()
        from kubedtn_tpu_torch.updates.stager import StagingBusyError

        stager = self.plane.update_stager(stats=self.update_stats)
        try:
            stage = stager.stage(plan, topo,
                                 observe_ticks=self.observe_ticks,
                                 guardrails=self.guardrails)
        except StagingBusyError as e:
            # another staging in progress: a transient condition — fail
            # the pass so the key requeues and retries next drain.
            # (Deliberately NOT `except RuntimeError`: device errors
            # are RuntimeErrors too and belong to the failure branch.)
            result.ok = False
            result.action = "plan-busy"
            self.log.warning("staging busy %s", _fields(
                topology=key, error=str(e)))
            return True
        except Exception:
            # unexpected staging failure: the stager already rolled the
            # applied rounds back before re-raising — swallow it HERE so
            # one topology's failure cannot abort a serial drain() pass
            # mid-loop (stranding every other pending delta after the
            # watch events were consumed); fail the pass and requeue
            result.ok = False
            result.action = "plan-failed"
            if self.update_stats is not None:
                self.update_stats.record_plan_error()
            self.log.exception("staged update failed %s",
                               _fields(topology=key))
            return True
        result.phase_ms["stage"] = (time.perf_counter() - t0) * 1e3
        if stage.ok:
            result.action = "planned"
            return True
        result.ok = False
        result.action = "plan-rolled-back"
        self.log.warning("staged update rolled back %s", _fields(
            topology=key, reason=stage.reason))
        return True

    def drain(self, max_passes: int = 64,
              workers: int = 1) -> list[ReconcileResult]:
        """Process watch events until the store is steady — the loop the
        controller-runtime manager provides in the reference
        (reference main.go:104-110). workers>1 runs the reference's
        concurrent-reconciler shape (MaxConcurrentReconciles=32,
        topology_controller.go:336) over a WorkQueue, preserving
        per-topology ordering."""
        if workers > 1:
            return self._drain_concurrent(max_passes, workers)
        results: list[ReconcileResult] = []
        for _ in range(max_passes):
            events = list(self._watch.poll())
            retries, self._requeue = self._requeue, set()
            if not events and not retries:
                return results
            seen: set[tuple[str, str]] = set()
            for nk in [(ev.topology.namespace, ev.topology.name)
                       for ev in events] + sorted(retries):
                if nk in seen:
                    continue
                seen.add(nk)
                res = self.reconcile(*nk)
                if not res.ok and res.retryable:
                    self._requeue.add(nk)
                results.append(res)
        return results

    def _drain_concurrent(self, max_passes: int,
                          workers: int) -> list[ReconcileResult]:
        q = WorkQueue()
        results: list[ReconcileResult] = []
        lock = threading.Lock()
        attempts: dict[tuple[str, str], int] = {}
        stop = threading.Event()

        errors: list[Exception] = []

        def work() -> None:
            while True:
                key = q.get(timeout=0.02)
                if key is None:
                    if stop.is_set():
                        return
                    continue
                try:
                    res = self.reconcile(*key)
                    with lock:
                        results.append(res)
                        if not res.ok and res.retryable:
                            attempts[key] = attempts.get(key, 0) + 1
                            if attempts[key] < max_passes:
                                q.add(key)  # bounded in-drain retry
                            else:
                                self._requeue.add(key)  # next drain
                except Exception as e:  # e.g. retry_on_conflict exhausted
                    # surface it like the serial path would (re-raised by
                    # the pump loop below); the key re-queues so a later
                    # drain can still converge
                    with lock:
                        errors.append(e)
                        self._requeue.add(key)
                finally:
                    # ALWAYS release the key: a skipped done() would pin
                    # it in _processing and hang the drain forever
                    q.done(key)

        threads = [threading.Thread(target=work, daemon=True,
                                    name=f"reconcile-{i}")
                   for i in range(workers)]
        for t in threads:
            t.start()
        retries, self._requeue = self._requeue, set()
        for nk in sorted(retries):
            q.add(nk)
        try:
            while True:
                with lock:
                    if errors:
                        raise errors[0]
                pumped = 0
                for ev in self._watch.poll():
                    q.add((ev.topology.namespace, ev.topology.name))
                    pumped += 1
                if pumped == 0 and q.idle():
                    # workers emit status-copy events BEFORE q.done(), so
                    # with the queue idle any stragglers are already in
                    # the watch deque — one more empty poll means steady
                    stragglers = list(self._watch.poll())
                    if not stragglers:
                        break
                    for ev in stragglers:
                        q.add((ev.topology.namespace, ev.topology.name))
                time.sleep(0.001)
        finally:
            stop.set()
            q.shut_down()
            for t in threads:
                t.join(timeout=5)
        return results

    def reconcile_all(self) -> list[ReconcileResult]:
        """Full-cluster pass (startup resync)."""
        return [
            self.reconcile(t.namespace, t.name) for t in self.store.list()
        ]
