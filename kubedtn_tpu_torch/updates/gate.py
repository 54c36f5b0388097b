"""Verification gate — dry-run a planned update in the twin before it
touches the live plane.

The planner (updates.planner) guards topology; this gate guards
SERVICE: it forks a consistent snapshot of the running plane
(twin.snapshot.snapshot_from_plane — one flush barrier, the runner
never stops), replays the schedule's rounds as CUMULATIVE what-if
scenarios (round k's replica carries every edit of rounds 1..k, which
is exactly the state the live plane would be in between round k and
k+1), and rejects the plan if ANY intermediate or final state
regresses delivery ratio or p99 shaping latency beyond the configured
guardrails versus the unperturbed baseline replica.

Vocabulary mapping (zero translation loss, see planner docstring):
CHANGE → `degrade` (update_links qdisc-reinstall semantics), DELETE →
`fail`. ADDS cannot be replayed against the snapshot (their rows do
not exist in the captured edge state) and only ever add capacity in
the per-edge shaping model — they are counted in
`GateVerdict.skipped_adds` rather than silently vanishing.

One sweep verifies the whole schedule: N rounds + baseline = N+1
replicas advanced together (twin.engine.run_sweep: each shaping slot of
a step is one launch of kernel K1 over every replica's rows), so the
gate's latency is a single what-if sweep regardless of round count —
that latency accumulates in UpdateStats.gate_s (the JAX package exports
it as `kubedtn_update_gate_seconds`).

Horizon rule: the sweep's delivery metric counts pops WITHIN the
horizon (`Guardrails.ticks * dt_us`), so a pure latency increase costs
roughly Δlatency/horizon of delivery ratio — keep the horizon well
above the topology's latency scale (the 400-tick/400ms default gives a
+1ms change a ~0.25% footprint, inside the 2% guardrail) or widen
`max_delivery_drop` when probing with short horizons.

Port of kubedtn_tpu/updates/gate.py; the snapshot's columns are read on
the host wherever they lie.
"""

from __future__ import annotations

import dataclasses
import time

from kubedtn_tpu_torch.twin.engine import run_sweep
from kubedtn_tpu_torch.twin.spec import Perturbation, Scenario, _host


@dataclasses.dataclass(frozen=True)
class Guardrails:
    """The gate's regression thresholds and sweep horizon. The same
    thresholds drive the stager's live watch, so "what the gate
    promised" and "what staging enforces" are one configuration."""

    max_delivery_drop: float = 0.02   # absolute delivery-ratio drop
    max_p99_factor: float = 1.5       # p99 may grow at most this factor
    min_p99_slack_us: float = 500.0   # ...and by at least this much
    # ABSOLUTE p99 ceiling (0 = off): the SLO plane's hook — a
    # tenant's latency objective binds regardless of what the baseline
    # happened to be (a plan that keeps p99 "only 1.2x" a baseline
    # already past the bound must still be rejected)
    max_p99_us: float = 0.0
    ticks: int = 400                  # sweep horizon (virtual ticks)
    dt_us: float = 1000.0
    seed: int = 0
    k_slots: int = 4

    def check(self, delivery_ratio, p99_us, base_delivery,
              base_p99) -> tuple[bool, str]:
        """ONE threshold evaluation for both halves of the contract —
        the gate's replica verdicts and the stager's live watch windows
        ("what the gate promised is what staging enforces" must not be
        two hand-kept copies of the comparison). None values skip their
        check (metric not measurable)."""
        if (base_delivery is not None and delivery_ratio is not None
                and delivery_ratio < base_delivery
                - self.max_delivery_drop):
            return (False,
                    f"delivery {delivery_ratio:.4f} < baseline "
                    f"{base_delivery:.4f} - {self.max_delivery_drop}")
        if (base_p99 is not None and p99_us is not None
                and p99_us > base_p99 * self.max_p99_factor
                and p99_us - base_p99 > self.min_p99_slack_us):
            return (False,
                    f"p99 {p99_us:.0f}us > baseline {base_p99:.0f}us "
                    f"x {self.max_p99_factor}")
        if (self.max_p99_us > 0.0 and p99_us is not None
                and p99_us > self.max_p99_us):
            return (False,
                    f"p99 {p99_us:.0f}us > SLO bound "
                    f"{self.max_p99_us:.0f}us")
        return True, ""

    @classmethod
    def from_slo(cls, slo, **overrides) -> "Guardrails":
        """Guardrails derived from a tenant's SLO — the autopilot
        input hook: the plan → gate → stage pipeline verifies a change
        against what the tenant was PROMISED (slo.spec.SloSpec) or,
        tighter, against what it has LEFT (slo.spec.SloVerdict: the
        allowed delivery drop scales with the remaining error budget —
        a tenant already burning hot gets almost no headroom).

        Mapping: `max_delivery_drop` = the SLO's error budget
        (1 − floor), scaled by `budget_remaining` for a verdict;
        `max_p99_us` = the p99 bound, absolute. The relative
        factor/slack checks keep their defaults (still useful against
        regressions well under the bound). `overrides` pass through to
        the constructor (ticks, seed, ...)."""
        spec = getattr(slo, "spec", slo)   # SloVerdict carries .spec
        budget = 1.0 - float(spec.delivery_ratio_floor)
        remaining = getattr(slo, "budget_remaining", None)
        if remaining is not None:
            budget *= max(0.0, min(1.0, float(remaining)))
        kw = {
            "max_delivery_drop": round(budget, 6),
            "max_p99_us": float(spec.p99_bound_us or 0.0),
        }
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass
class GateVerdict:
    """The gate's answer: `ok` plus the evidence behind it."""

    ok: bool
    reason: str                 # "" when ok
    baseline: dict              # delivery_ratio / p99_us of replica 0
    rounds: list                # per-round {name, delivery_ratio, p99_us, ok}
    skipped_adds: int           # adds (never replayable on a snapshot)
    gate_s: float
    replicas: int = 0
    ticks: int = 0
    # changes/deletes whose uid had no matching row in the snapshot —
    # distinct from adds: an unverified CHANGE is a gap worth seeing,
    # not the benign structural adds-can't-replay case
    skipped_edits: int = 0


def _round_scenarios(plan, snapshot,
                     local_node: int | None = None
                     ) -> tuple[list, int, int]:
    """Cumulative per-round scenarios + the counts of edits the
    snapshot cannot represent: (scenarios, skipped adds, skipped
    changes/dels on uids with no matching rows).

    `local_node` is the plan topology's node id when the caller can
    resolve it (verify_plan does, via pod_ids): a CHANGE then degrades
    only the LOCAL directed row — exactly `update_links`' local-end
    semantics, so the gate verifies the same end state staging will
    produce (a uid-wide degrade would also rewrite the peer row, and
    an asymmetric peer configuration would make the verdict diverge
    from the staged result). DELETEs stay uid-wide: `del_links` kills
    both directions."""
    uid_arr = _host(snapshot.sim.edges.uid)
    active = _host(snapshot.sim.edges.active)
    src = _host(snapshot.sim.edges.src)
    present = {int(u) for u in uid_arr[active]}
    if local_node is not None:
        local_present = {int(u) for u in
                         uid_arr[active & (src == int(local_node))]}
    else:
        local_present = present
    cum: dict[int, Perturbation] = {}
    skipped_adds = 0
    skipped_edits = 0
    scenarios: list[Scenario] = []
    for rnd in plan.rounds:
        skipped_adds += len(rnd.adds)
        for link in rnd.changes:
            if link.uid not in local_present:
                skipped_edits += 1
                continue
            prev = cum.get(link.uid)
            if prev is not None and prev.kind == "fail":
                continue  # a prior round failed it; fail dominates
            cum[link.uid] = Perturbation(
                "degrade", uid=link.uid, props=link.properties,
                src_node=local_node)
        for link in rnd.dels:
            if link.uid in present:
                cum[link.uid] = Perturbation("fail", uid=link.uid)
            else:
                skipped_edits += 1
        scenarios.append(Scenario(name=f"round-{rnd.index + 1}",
                                  perturbations=tuple(cum.values())))
    return scenarios, skipped_adds, skipped_edits


def _metric_pair(m: dict) -> dict:
    return {"delivery_ratio": m.get("delivery_ratio"),
            "p99_us": m.get("p99_us"),
            "throughput_bps": m.get("throughput_bps")}


def verify_plan_live(plane, plan, *,
                     guardrails: Guardrails | None = None,
                     spec=None, mesh=None) -> GateVerdict:
    """`verify_plan` against a consistent fork of the RUNNING plane:
    owns the snapshot barrier and the engine pod-id capture, so every
    live gate call site resolves blackhole/node names identically (a
    caller hand-rolling the triplet can forget pod_ids and silently
    verify with a different demand mapping)."""
    from kubedtn_tpu_torch.twin.snapshot import snapshot_from_plane

    snap = snapshot_from_plane(plane)
    engine = plane.engine
    with engine._lock:
        pod_ids = dict(engine._pod_ids)
    return verify_plan(plan, snap, guardrails=guardrails,
                       pod_ids=pod_ids, spec=spec, mesh=mesh)


def gate_scenarios(plan, snapshot, pod_ids=None):
    """The gate's EXACT sweep input: baseline + cumulative per-round
    scenarios, plus the skipped-edit counts. One assembly point shared
    by `verify_plan` (which runs it) and the JAX package's dtnverify
    (which traces the same program for IR-level contract checks), so
    the verified gate sweep cannot drift from the served one. Returns ``(scenarios, skipped_adds,
    skipped_edits)`` with ``scenarios[0]`` the unperturbed baseline."""
    local_node = (pod_ids or {}).get(plan.key)
    rounds, skipped_adds, skipped_edits = _round_scenarios(
        plan, snapshot, local_node=local_node)
    if not rounds or all(not sc.perturbations for sc in rounds):
        return [], skipped_adds, skipped_edits
    return ([Scenario(name="baseline"), *rounds], skipped_adds,
            skipped_edits)


def verify_plan(plan, snapshot, *, guardrails: Guardrails | None = None,
                pod_ids=None, spec=None, mesh=None,
                draws=None) -> GateVerdict:
    """Replay the schedule against `snapshot` and return the verdict.

    `spec`/`mesh`/`draws` pass through to `run_sweep` (defaults: the
    query surface's CBR-everywhere offered load, unsharded, the seeded
    generator). A plan with no
    replayable edits (adds only / empty) passes trivially — the gate
    verifies service under the edits it CAN represent and reports the
    rest in `skipped_adds`."""
    g = guardrails or Guardrails()
    t0 = time.perf_counter()
    scenarios, skipped_adds, skipped_edits = gate_scenarios(
        plan, snapshot, pod_ids=pod_ids)
    if not scenarios:
        return GateVerdict(
            ok=True, reason="", baseline={}, rounds=[],
            skipped_adds=skipped_adds, skipped_edits=skipped_edits,
            gate_s=round(time.perf_counter() - t0, 3))
    result = run_sweep(
        snapshot, scenarios,
        steps=g.ticks, dt_us=g.dt_us, seed=g.seed, k_slots=g.k_slots,
        pod_ids=pod_ids, spec=spec, mesh=mesh, draws=draws)
    base = result.metrics[0]
    # The gate's delivery ratio is delivered / the BASELINE offered
    # load, not the replica's own tx: a failed/deleted edge stops
    # COUNTING its offered packets (the generator masks inactive rows),
    # so the per-replica ratio would read a dead link as healthy. Held
    # against the baseline denominator, lost serving capacity is a
    # regression — which makes the gate's default position that an
    # INTENTIONAL capacity removal needs a widened max_delivery_drop
    # (documented in ARCHITECTURE.md "Planned updates").
    b_tx = base.get("tx_packets") or 0.0
    b_ratio = (base.get("delivered_packets", 0.0) / b_tx
               if b_tx > 0 else None)
    b_p99 = base.get("p99_us")
    rounds: list[dict] = []
    ok, reason = True, ""
    for name, m in zip(result.names[1:], result.metrics[1:]):
        r_ratio = (m.get("delivered_packets", 0.0) / b_tx
                   if b_tx > 0 else None)
        r_p99 = m.get("p99_us")
        r_ok, r_why = g.check(r_ratio, r_p99, b_ratio, b_p99)
        rounds.append({"name": name, **_metric_pair(m),
                       "delivery_ratio": r_ratio, "ok": r_ok,
                       "why": r_why})
        if ok and not r_ok:
            ok, reason = False, f"{name}: {r_why}"
    baseline = {**_metric_pair(base), "delivery_ratio": b_ratio}
    return GateVerdict(
        ok=ok, reason=reason, baseline=baseline,
        rounds=rounds, skipped_adds=skipped_adds,
        skipped_edits=skipped_edits,
        gate_s=round(time.perf_counter() - t0, 3),
        replicas=result.replicas, ticks=result.ticks)
