"""The autopilot controller — burn-rate page → twin-gated remediation.

Port of kubedtn_tpu/autopilot/controller.py (unchanged but for
`_edge_props`, which copies the fork's uid and active columns off the
device once each).

A daemon sidecar (the SloEvaluator pattern: a polling thread, zero
tick-path involvement) runs one cooldown/hysteresis state machine per
tenant:

    observe --page x N--> search --winner--> stage --staged--> verify
       ^                    |                  |                  |
       |                    +--no candidate---+--rejected/       |
       +------cooldown------+      rolled back-------------------+
              (hold)                                    green / stale

- observe: count consecutive paging polls (`SloEvaluator.verdicts` —
  O(tenants) per poll); `page_polls` of hysteresis before acting, so
  a single-window spike cannot trigger a search.
- search:  candidate grid → ONE batched twin sweep on the tenant's
  snapshot fork → ranked by projected burn (autopilot.search).
- stage:   the winner through plan → gate → stage
  (autopilot.actuator); `dry_run` records the would-be action
  instead.
- verify:  wait up to `verify_polls` polls for the burn to drop below
  page; green records time-to-green, stale counts a failure.
- hold:    cooldown before the tenant can page again — with the
  two-sided hysteresis (page_polls in, cooldown_s out) the loop
  cannot flap.

Escalation: `escalate_after` consecutive failed local remediations on
any tenant, or `fleet_page_tenants` tenants paging in one poll, feeds
the fleet supervisor's rebalance (federation/placement.rebalance_plan
→ live migrations) instead of more local tuning.

Every action lands in a bounded history ring (the `kdt autopilot
history` surface) and in `AutopilotStats` (the `kubedtn_autopilot_*`
metrics). Determinism: the grid and the sweep derive from
`config.seed` and the verdict alone, so same seed + same burn verdict
=> same winning delta (pinned by test).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from kubedtn_tpu_torch.autopilot.actuator import actuate, _tenant_topologies
from kubedtn_tpu_torch.autopilot.candidates import candidate_grid
from kubedtn_tpu_torch.autopilot.search import score_candidates
from kubedtn_tpu_torch.contracts import guarded_by, requires_lock
from kubedtn_tpu_torch.slo.spec import SEV_PAGE
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

ST_OBSERVE = "observe"
ST_VERIFY = "verify"
ST_HOLD = "hold"
# transient poll-scoped phases, surfaced in the action record rather
# than the resting state (a poll never parks a tenant in them)
ST_SEARCH = "search"
ST_STAGE = "stage"

STATE_LEVELS = {ST_OBSERVE: 0, ST_SEARCH: 1, ST_STAGE: 2,
                ST_VERIFY: 3, ST_HOLD: 4}


class AutopilotStats:
    """Thread-safe counters behind `kubedtn_autopilot_*`."""

    KEYS = ("pages_seen", "searches_run", "candidates_evaluated",
            "deltas_staged", "deltas_rolled_back", "deltas_rejected",
            "quota_actions", "escalations", "no_candidate",
            "dry_runs", "greens", "stales", "errors")
    SECONDS = ("time_to_green_s", "sweep_compile_s", "sweep_run_s")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for k in self.KEYS + self.SECONDS:
            setattr(self, k, 0 if k in self.KEYS else 0.0)

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {k: getattr(self, k)
                    for k in self.KEYS + self.SECONDS}


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """The loop's dials. Everything that shapes a decision is here —
    the controller itself holds no tunable state, so a config + seed
    fully determines the loop's behavior on a given verdict stream."""

    seed: int = 0
    width: int = 4               # seeded exploration block size
    page_polls: int = 2          # consecutive paging polls to act
    cooldown_s: float = 30.0     # hold after any action
    verify_polls: int = 10       # polls to wait for green
    steps: int = 400             # sweep horizon (ticks)
    dt_us: float = 1000.0        # sweep tick size
    k_slots: int = 4
    observe_ticks: int = 2       # stager watch window per round
    escalate_after: int = 2      # failed remediations => escalate
    fleet_page_tenants: int = 3  # paging tenants in one poll => fleet
    max_history: int = 256
    # (key, value) overrides for Guardrails.from_slo
    guardrail_overrides: tuple = ()


def _fresh_state() -> dict:
    return {"state": ST_OBSERVE, "pages": 0, "page_t0": None,
            "hold_until": 0.0, "verify_left": 0, "fails": 0,
            "last_action_id": 0}


@guarded_by("_lock", "_states", "_history", "_enabled", "_dry_run",
            "_next_id", "_last_escalate")
class Autopilot:
    """Daemon-sidecar controller closing burn-rate → remediation."""

    def __init__(self, registry, plane, evaluator, *, fleet=None,
                 config: AutopilotConfig | None = None,
                 stats: AutopilotStats | None = None,
                 clock=time.monotonic, tick_driver=None) -> None:
        self.registry = registry
        self.plane = plane
        self.evaluator = evaluator
        self.fleet = fleet
        self.config = config if config is not None else AutopilotConfig()
        self.stats = stats if stats is not None else AutopilotStats()
        self.clock = clock
        self.tick_driver = tick_driver
        self.log = get_logger("autopilot")
        self._lock = threading.Lock()
        self._states: dict[str, dict] = {}
        self._history: list[dict] = []
        self._enabled = False
        self._dry_run = False
        self._next_id = 1
        self._last_escalate = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def attach(self, daemon) -> "Autopilot":
        """Install as the daemon's Local.Autopilot* surface."""
        daemon.autopilot = self
        return self

    # -- switches ------------------------------------------------------

    def enable(self) -> None:
        with self._lock:
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False

    def set_dry_run(self, flag: bool) -> None:
        with self._lock:
            self._dry_run = bool(flag)

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self._enabled

    @property
    def dry_run(self) -> bool:
        with self._lock:
            return self._dry_run

    # -- the loop ------------------------------------------------------

    def start(self, poll_s: float = 1.0) -> None:
        """Run `poll()` on a sidecar thread until `stop()`."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(poll_s):
                try:
                    self.poll()
                except Exception as e:  # keep the sidecar alive
                    self.stats.add(errors=1)
                    self.log.warning("autopilot poll failed %s",
                                     _fields(error=repr(e)))

        self._thread = threading.Thread(target=loop,
                                        name="kdt-autopilot",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def poll(self) -> list:
        """One state-machine step over the evaluator's verdicts.
        O(tenants) host work per poll; a search/stage step costs one
        sweep + one gate, and at most one tenant remediates per poll
        (the others keep counting hysteresis) so a fleet-wide burn
        cannot pile sweeps into a single poll."""
        verdicts = self.evaluator.verdicts()
        now = self.clock()
        actions: list = []
        with self._lock:
            enabled, dry = self._enabled, self._dry_run
        acted = False
        paging = []
        for name in sorted(verdicts):
            v = verdicts[name]
            st = self._state_of(name)
            sev_page = v.severity == SEV_PAGE
            if sev_page:
                paging.append(name)
            if st["state"] == ST_HOLD:
                if now >= st["hold_until"]:
                    self._reset(name)
                continue
            if st["state"] == ST_VERIFY:
                self._verify_step(name, st, v, now)
                continue
            # observe
            if not sev_page:
                if st["pages"]:
                    self._reset(name)
                continue
            with self._lock:
                st["pages"] += 1
                if st["page_t0"] is None:
                    st["page_t0"] = now
            self.stats.add(pages_seen=1)
            if (enabled and not acted
                    and st["pages"] >= self.config.page_polls):
                act = self._remediate(name, v, now, dry)
                actions.append(act)
                acted = True
        esc = self._maybe_escalate(paging, now, enabled, dry)
        if esc is not None:
            actions.append(esc)
        return actions

    # -- state helpers -------------------------------------------------

    def _state_of(self, name: str) -> dict:
        with self._lock:
            st = self._states.get(name)
            if st is None:
                st = self._states[name] = _fresh_state()
            return st

    def _reset(self, name: str) -> None:
        with self._lock:
            st = self._states[name]
            st.update(state=ST_OBSERVE, pages=0, page_t0=None,
                      verify_left=0)

    def _hold(self, name: str, now: float) -> None:
        with self._lock:
            st = self._states[name]
            st.update(state=ST_HOLD, pages=0,
                      hold_until=now + self.config.cooldown_s)

    def _verify_step(self, name: str, st: dict, v, now: float) -> None:
        if v.severity != SEV_PAGE:
            t0 = st["page_t0"]
            ttg = (now - t0) if t0 is not None else 0.0
            self.stats.add(greens=1, time_to_green_s=ttg)
            with self._lock:
                st["fails"] = 0
            self._amend_last(name, verdict="green", time_to_green_s=ttg)
            self.log.info("autopilot green %s", _fields(
                tenant=name, time_to_green_s=round(ttg, 3)))
            self._hold(name, now)
            return
        with self._lock:
            st["verify_left"] -= 1
            stale = st["verify_left"] <= 0
            if stale:
                st["fails"] += 1
        if stale:
            self.stats.add(stales=1)
            self._amend_last(name, verdict="stale")
            self._hold(name, now)

    # -- the search/stage step -----------------------------------------

    def _edge_props(self, snap, name: str) -> dict:
        """The tenant's live uid → LinkProperties map, restricted to
        rows active in the snapshot fork (the twin compiler rejects
        edits against inactive rows)."""
        uid_arr = snap.sim.edges.uid.cpu().numpy()
        act = snap.sim.edges.active.cpu().numpy()
        live = {int(u) for u in uid_arr[act]}
        props: dict = {}
        for topo in _tenant_topologies(self.plane.engine,
                                       self.registry, name):
            for link in topo.status.links:
                if link.uid in live and link.uid not in props:
                    props[link.uid] = link.properties
        return props

    def _remediate(self, name: str, v, now: float, dry: bool) -> dict:
        cfg = self.config
        rec = self._new_record(name, v, now)
        try:
            snap = self.registry.tenant_snapshot(self.plane, name)
            edge_props = self._edge_props(snap, name)
            grid = candidate_grid(v, edge_props, seed=cfg.seed,
                                  width=cfg.width)
            sr = score_candidates(
                snap, name, v.qos, v.spec, grid, verdict=v,
                steps=cfg.steps, dt_us=cfg.dt_us, seed=cfg.seed,
                k_slots=cfg.k_slots)
        except Exception as e:
            self.stats.add(errors=1)
            rec.update(verdict="error", reason=f"search: {e!r}")
            self._record(name, rec, now, hold=True)
            return rec
        self.stats.add(searches_run=1,
                       candidates_evaluated=sr.candidates,
                       sweep_compile_s=sr.compile_s,
                       sweep_run_s=sr.run_s)
        rec.update(candidates=sr.candidates,
                   baseline_burn=round(sr.baseline_burn, 6),
                   compile_s=round(sr.compile_s, 6),
                   run_s=round(sr.run_s, 6))
        if sr.winner is None:
            self.stats.add(no_candidate=1)
            rec.update(verdict="no-candidate",
                       reason="no candidate improves the projected "
                              "burn")
            self._record(name, rec, now, hold=True)
            return rec
        best = sr.ranked[0]
        rec.update(kind=sr.winner.kind, candidate=sr.winner.name,
                   projected_burn=round(best.projected_burn, 6))
        try:
            out = actuate(self.plane, self.registry, name, sr.winner,
                          v, overrides=cfg.guardrail_overrides,
                          observe_ticks=cfg.observe_ticks,
                          tick_driver=self.tick_driver, dry_run=dry)
        except Exception as e:
            self.stats.add(errors=1)
            rec.update(verdict="error", reason=f"actuate: {e!r}")
            self._record(name, rec, now, hold=True)
            return rec
        rec.update(staged=out.staged, rejected=out.rejected,
                   rolled_back=out.rolled_back, dry_run=out.dry_run,
                   reason=out.reason, plans=len(out.plans),
                   gate_s=round(out.gate_s, 6),
                   stage_s=round(out.stage_s, 6))
        if out.quota_before is not None:
            rec["quota_before"] = out.quota_before
            rec["quota_after"] = out.quota_after
        if dry:
            self.stats.add(dry_runs=1)
            rec["verdict"] = "dry-run"
            self._record(name, rec, now, hold=True)
            return rec
        if out.rejected:
            self.stats.add(deltas_rejected=1)
            rec["verdict"] = "rejected"
            self._fail(name)
            self._record(name, rec, now, hold=True)
            return rec
        if out.rolled_back or not out.ok:
            self.stats.add(deltas_rolled_back=int(out.rolled_back))
            rec["verdict"] = "rolled-back" if out.rolled_back \
                else "failed"
            self._fail(name)
            self._record(name, rec, now, hold=True)
            return rec
        if out.kind in ("quota", "drain"):
            self.stats.add(quota_actions=1)
        else:
            self.stats.add(deltas_staged=1)
        rec["verdict"] = "staged"
        self._record(name, rec, now, hold=False)
        with self._lock:
            self._states[name].update(state=ST_VERIFY,
                                      verify_left=cfg.verify_polls)
        self.log.info("autopilot staged %s", _fields(
            tenant=name, candidate=rec.get("candidate", ""),
            projected_burn=rec.get("projected_burn", 0.0)))
        return rec

    def _fail(self, name: str) -> None:
        with self._lock:
            self._states[name]["fails"] += 1

    # -- escalation ----------------------------------------------------

    def _maybe_escalate(self, paging: list, now: float, enabled: bool,
                        dry: bool):
        """Sustained multi-tenant burn, or a tenant local remediation
        keeps failing → the fleet tier (supervisor rebalance → live
        migrations), rate-limited by the cooldown."""
        if not enabled or self.fleet is None:
            return None
        with self._lock:
            failed = [n for n, st in sorted(self._states.items())
                      if st["fails"] >= self.config.escalate_after]
            wide = len(paging) >= self.config.fleet_page_tenants
            if not failed and not wide:
                return None
            if now - self._last_escalate < self.config.cooldown_s:
                return None
            self._last_escalate = now
        rec = {"id": self._take_id(), "t": now, "tenant": "",
               "kind": "escalate", "candidate": "fleet:rebalance",
               "verdict": "escalated", "dry_run": dry,
               "reason": ("fleet-wide burn: "
                          + ",".join(sorted(paging)) if wide
                          else "local remediation exhausted: "
                          + ",".join(failed))}
        if dry:
            rec["verdict"] = "dry-run"
        else:
            try:
                moves = self.fleet.rebalance()
                rec["moves"] = len(moves)
            except Exception as e:
                self.stats.add(errors=1)
                rec.update(verdict="error",
                           reason=f"rebalance: {e!r}")
        self.stats.add(escalations=1)
        with self._lock:
            for n in failed:
                self._states[n]["fails"] = 0
            self._push_history(rec)
        self.log.info("autopilot escalated %s", _fields(
            reason=rec["reason"], verdict=rec["verdict"]))
        return rec

    # -- records -------------------------------------------------------

    def _take_id(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
            return i

    def _new_record(self, name: str, v, now: float) -> dict:
        return {"id": self._take_id(), "t": now, "tenant": name,
                "kind": "", "candidate": "", "verdict": "",
                "reason": "", "staged": False, "rejected": False,
                "rolled_back": False, "dry_run": False,
                "candidates": 0, "plans": 0, "baseline_burn": 0.0,
                "projected_burn": 0.0, "compile_s": 0.0,
                "run_s": 0.0, "gate_s": 0.0, "stage_s": 0.0,
                "time_to_green_s": 0.0}

    @requires_lock("_lock")
    def _push_history(self, rec: dict) -> None:
        self._history.append(rec)
        drop = len(self._history) - self.config.max_history
        if drop > 0:
            del self._history[:drop]

    def _record(self, name: str, rec: dict, now: float,
                hold: bool) -> None:
        with self._lock:
            self._states[name]["last_action_id"] = rec["id"]
            self._push_history(rec)
        if hold:
            self._hold(name, now)

    def _amend_last(self, name: str, **kw) -> None:
        """Fold the verify outcome into the tenant's last action (one
        record per remediation, not one per poll)."""
        with self._lock:
            aid = self._states.get(name, {}).get("last_action_id", 0)
            for rec in reversed(self._history):
                if rec["id"] == aid:
                    rec.update(kw)
                    return

    # -- surfaces ------------------------------------------------------

    def status(self) -> dict:
        """The `kdt autopilot status` / metrics view: switches, the
        per-tenant resting states, and each tenant's last action."""
        now = self.clock()
        with self._lock:
            by_id = {r["id"]: r for r in self._history}
            states = {}
            for name in sorted(self._states):
                st = self._states[name]
                last = by_id.get(st["last_action_id"])
                states[name] = {
                    "state": st["state"], "pages": st["pages"],
                    "fails": st["fails"],
                    "hold_remaining_s": max(
                        0.0, st["hold_until"] - now)
                    if st["state"] == ST_HOLD else 0.0,
                    "last_action": dict(last) if last else None,
                }
            return {"enabled": self._enabled,
                    "dry_run": self._dry_run,
                    "running": self._thread is not None,
                    "tenants": states,
                    "stats": self.stats.snapshot()}

    def history(self, tenant: str = "", limit: int = 50) -> list:
        with self._lock:
            recs = [r for r in self._history
                    if not tenant or r["tenant"] == tenant]
        return [dict(r) for r in recs[-max(0, int(limit)):]]

    def last_action(self, tenant: str) -> dict | None:
        acts = self.history(tenant, limit=1)
        return acts[-1] if acts else None


def autopilot_for(daemon) -> "Autopilot | None":
    """The daemon's attached controller, if any."""
    return getattr(daemon, "autopilot", None)
