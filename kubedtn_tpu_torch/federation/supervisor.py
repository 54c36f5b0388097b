"""Fleet supervisor — plane health, automated tenant evacuation, and
zero-loss rolling upgrades.

Turns N independent daemons into ONE operable fleet:

- **Health watching.** Every registered plane is probed through the
  rich `Local.Health` surface (heartbeat age, watchdog stalls,
  degradation-ladder rung, tick errors, backlog, tenant count,
  capacity headroom — signals that until now only the Prometheus
  endpoint exported) and run through a suspicion state machine with
  hysteresis:

      healthy → suspect   after `suspect_after` consecutive probe
                          failures, OR `suspect_after` consecutive
                          degraded answers (serving=False: bottom
                          ladder rung / watchdog stall)
      suspect → dead      only via HARD failures (the probe itself
                          raising) — `dead_after` consecutive; a plane
                          that still answers is sick, never dead
      suspect → healthy   after `healthy_after` consecutive clean
                          probes (hysteresis: one good answer never
                          clears suspicion)
      dead    → (final)   until `mark_restarted` — a zombie coming
                          back must not silently double-serve tenants
                          that were evacuated off it

- **Placement.** A crash-safe journaled ledger (federation.placement —
  tenant→plane, the checkpoint `.prev` double-crash discipline) plus a
  deterministic score policy (QoS pressure, admitted load, capacity
  headroom). Rebalance decisions execute as live migrations.

- **Evacuation.** A plane declared DEAD has its tenants cold-restored
  onto survivors with NO operator action: in-flight migrations
  touching the dead plane resolve per the migration crash contract
  (pre-cutover → rollback / re-fork elsewhere from the journal's fork
  capture; post-cutover → roll forward), then every placed tenant is
  sliced out of the dead plane's last crash-consistent checkpoint
  (bounded by the `--checkpoint-interval` autosave — the RPO) and
  replayed through the ONE restore implementation
  (migrate.restore_tenant_slice), cumulative delivery counters riding
  with the rows. The checkpoint-to-death gap is REPORTED as
  exactly-accounted loss per tenant, never hidden:

      fed == delivered_src + delivered_dst + reported_lost

  with `delivered_src` the durable checkpoint counters,
  `delivered_dst` the survivor's live counters past them, and the
  `kubedtn_migration_accounting_mismatch` gauge extended to failover
  (nonzero ⇔ the internal accounting over-explains the feed — a
  duplicate-delivery bug, the thing the discipline exists to catch).

- **Rolling upgrade** (`kdt fleet upgrade`): cordon → drain every
  tenant via live migration → restart the daemon binary (the handle's
  `restarter` hook: checkpoint → teardown → rebuild → new server) →
  health-verify (consecutive clean probes) → refill → next plane.
  Zero frame loss for every live-migrated tenant — each move is a full
  live migration with byte-exact accounting.

- **Orphan resume.** On (re)start the supervisor resumes every
  journaled migration left `running` by a crash — an interrupted
  migration no longer waits for an operator to run
  `kdt migrate --resume --id`. Rolled-back records stay refused.

Port of kubedtn_tpu/federation/supervisor.py. The suspicion machine,
the placement and evacuation order, the records and the accounting are
the JAX package's; what differs is where the state lives:

- `fork_from_checkpoint` reads either package's checkpoint directory
  (the same manifest and npz layout), parses its manifest once for the
  whole evacuation, and gathers the tenant's rows of each
  `edge_state.npz` column on the host with one numpy fancy index;
  the columns then go to the survivor's engine tensors through
  `restore_tenant_slice`, the one restore of a live migration;
- the evacuation's clock for restored in-flight frames is the
  survivor plane's `last_now_s` when it runs on an explicit clock, as in
  the JAX package; the port's plane releases only through its native
  timing wheel, so restored frames join its delay-line batches.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from kubedtn_tpu_torch import checkpoint as ckpt
from kubedtn_tpu_torch.contracts import guarded_by
from kubedtn_tpu_torch.federation import journal
from kubedtn_tpu_torch.federation.migrate import (MigrationCoordinator,
                                            MigrationError,
                                            discard_partial_restore,
                                            restore_tenant_slice)
from kubedtn_tpu_torch.federation.placement import (PlacementError,
                                              PlacementLedger,
                                              choose_plane)
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
RESTARTING = "restarting"   # intentional (upgrade): sweep skips it


class FleetError(RuntimeError):
    """A fleet-supervision operation could not complete."""


@guarded_by("_lock", "probes", "probe_failures", "sweeps", "evacuations",
            "evacuated_tenants", "evacuated_rows", "pending_restored",
            "orphans_resumed", "upgrades", "upgrade_migrations",
            "reported_lost", "transitions")
class FleetStats:
    """Cumulative fleet counters for the kubedtn_fleet_* Prometheus
    series (metrics.FleetStatsCollector)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.probes = 0
        self.probe_failures = 0
        self.sweeps = 0
        self.evacuations = 0
        self.evacuated_tenants = 0
        self.evacuated_rows = 0
        self.pending_restored = 0
        self.orphans_resumed = 0
        self.upgrades = 0
        self.upgrade_migrations = 0
        # GAUGE: reported_lost of the latest failover accounting check
        # — honest loss is REPORTED here, never hidden (the mismatch
        # gauge stays 0; this one carries the RPO gap)
        self.reported_lost = 0.0
        self.transitions: dict[str, int] = {}

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def add_transition(self, to_state: str) -> None:
        with self._lock:
            self.transitions[to_state] = \
                self.transitions.get(to_state, 0) + 1

    def set_reported_lost(self, v: float) -> None:
        with self._lock:
            self.reported_lost = float(v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "probes": self.probes,
                "probe_failures": self.probe_failures,
                "sweeps": self.sweeps,
                "evacuations": self.evacuations,
                "evacuated_tenants": self.evacuated_tenants,
                "evacuated_rows": self.evacuated_rows,
                "pending_restored": self.pending_restored,
                "orphans_resumed": self.orphans_resumed,
                "upgrades": self.upgrades,
                "upgrade_migrations": self.upgrade_migrations,
                "reported_lost": self.reported_lost,
                "transitions": dict(self.transitions),
            }


def grpc_probe(addr: str, timeout_s: float = 2.0):
    """A `PlaneHandle.probe` hook that dials the plane's Local.Health
    RPC — the out-of-process probe (a dead daemon fails the dial, the
    hard-failure signal the suspicion machine wants). Each probe opens
    and closes its own channel: a cached channel to a dead peer can
    report stale readiness."""
    def probe() -> dict:
        from kubedtn_tpu_torch.wire import proto as pb
        from kubedtn_tpu_torch.wire.client import DaemonClient

        client = DaemonClient(addr)
        try:
            r = client.Health(pb.HealthRequest(), timeout=timeout_s)
        finally:
            client.close()
        if not r.ok:
            raise FleetError(f"health probe of {addr}: {r.error}")
        return {
            "node": r.node,
            "running": bool(r.running),
            "serving": bool(r.serving),
            "heartbeat_age_s": (None if r.heartbeat_age_s < 0
                                else float(r.heartbeat_age_s)),
            "watchdog_stalls": int(r.watchdog_stalls),
            "watchdog_stalled": bool(r.watchdog_stalled),
            "degrade_level": int(r.degrade_level),
            "tick_errors": int(r.tick_errors),
            "ticks": int(r.ticks),
            "backlog": int(r.backlog),
            "holdback_wires": int(r.holdback_wires),
            "inflight": int(r.inflight),
            "pipeline_depth": int(r.pipeline_depth),
            "effective_depth": int(r.effective_depth),
            "tenants": int(r.tenants),
            "capacity": int(r.capacity),
            "active_rows": int(r.active_rows),
            "headroom_rows": int(r.headroom_rows),
        }

    return probe


class _PlaneWatch:
    """One plane's suspicion-machine state (mutated only under the
    supervisor's lock)."""

    __slots__ = ("state", "consec_fail", "consec_soft", "consec_ok",
                 "last_error", "last_ok_s", "last_health")

    def __init__(self) -> None:
        self.state = HEALTHY
        self.consec_fail = 0   # hard: the probe itself raised
        self.consec_soft = 0   # soft: answered, but serving=False
        self.consec_ok = 0
        self.last_error: str | None = None
        self.last_ok_s: float | None = None
        self.last_health: dict | None = None


def fork_from_checkpoint(ckpt_dir, tenant: str):
    """Slice ONE tenant out of a (dead) plane's last crash-consistent
    checkpoint generation, in the migration fork schema — the
    cold-restore source `restore_tenant_slice` replays. Returns
    (fork, arrays, counters, pending, src_addr):

    - fork/arrays — identities, peers, topologies, wires, registry
      config and the per-row dynamic columns, exactly as a live FORK
      would have captured them (shaped = active & any-props, the
      checkpoint-load rule);
    - counters — the tenant rows' slice of the checkpointed cumulative
      plane counters (the durable `delivered_src` half of the failover
      accounting), or None when the checkpoint predates the counters
      file;
    - pending — the tenant's checkpointed in-flight delay-line frames;
    - ingress — the tenant's checkpointed queued-but-undrained ingress
      frames (accepted by the dead plane, not yet shaped — they drain
      on the survivor's first tick);
    - src_addr — the dead plane's node_ip (placement rewrite anchor).

    Deliberately linear in the checkpoint (one pass over the row
    registry and one npz gather) — a cold evacuation path, budgeted
    like checkpoint_load. Raises FleetError when the checkpoint has no
    trace of the tenant. `ckpt_dir` may also be a
    `checkpoint.Generation` the caller already opened: the manifest is
    then parsed once for every file of the slice (and once per
    evacuation, which hands its Generation to each tenant's slice),
    where the JAX package parses it again in each of its readers — the
    same outputs, without four re-reads of a manifest of tens of MB a
    tenant."""
    gen = (ckpt_dir if isinstance(ckpt_dir, ckpt.Generation)
           else ckpt.Generation(ckpt_dir))
    manifest = gen.manifest
    section = manifest.get("tenancy") or {}
    cfg = next((t for t in section.get("tenants", ())
                if t["name"] == tenant), None)
    if cfg is None:
        raise FleetError(
            f"tenant {tenant!r} has no durable state in checkpoint "
            f"{ckpt_dir} (nothing to evacuate)")
    spaces = set(cfg.get("namespaces", ()))
    topologies = [
        {"manifest": r["manifest"],
         "finalizers": list(r.get("finalizers", ()))}
        for r in manifest.get("store", ())
        if r["manifest"]["metadata"].get("namespace", "default")
        in spaces]
    eng = manifest["engine"]
    pod_names = {v: k for k, v in eng["pod_ids"].items()}
    rows_list = sorted(
        ((pk, int(uid), int(row)) for pk, uid, row in eng["rows"]
         if pk.partition("/")[0] in spaces),
        key=lambda x: x[2])
    rows = np.asarray([r for _, _, r in rows_list], np.int64)
    with gen.npz("edge_state.npz") as z:
        src_col = np.asarray(z["src"])
        dst_col = np.asarray(z["dst"])
        props = np.asarray(z["props"])
        shaped_mask = np.asarray(z["active"]) & props.any(axis=1)
        identities = [
            [pk, uid, pod_names.get(int(src_col[r]), pk),
             pod_names.get(int(dst_col[r]), pk), bool(shaped_mask[r])]
            for pk, uid, r in rows_list]
        arrays = {
            "rows": rows,
            "props": props[rows],
            "tokens": np.asarray(z["tokens"])[rows],
            "t_last": np.asarray(z["t_last"])[rows],
            "corr": np.asarray(z["corr"])[rows],
            "pkt_count": np.asarray(z["pkt_count"])[rows],
            "backlog_until": np.asarray(z["backlog_until"])[rows],
        }
    keyset = {(pk, uid) for pk, uid, _r in rows_list}
    peers = sorted([a, int(b), c, int(d)]
                   for a, b, c, d in eng.get("peer", ())
                   if (a, int(b)) in keyset and (c, int(d)) in keyset)
    wires = [w for w in manifest.get("wires", ())
             if w[0].partition("/")[0] in spaces]
    counters = None
    all_counters = gen.plane_counters()
    if all_counters is not None:
        counters = {k: v[rows] for k, v in all_counters.items()}
    pending = [e for e in gen.pending_entries()
               if e[0].partition("/")[0] in spaces]
    ingress = [e for e in gen.ingress_entries()
               if e[0].partition("/")[0] in spaces]
    fork = {
        "identities": identities,
        "peers": peers,
        "topologies": topologies,
        "wires": wires,
        "registry": {
            "qos": cfg.get("qos", "gold"),
            "frame_budget_per_s": cfg.get("frame_budget_per_s"),
            "byte_budget_per_s": cfg.get("byte_budget_per_s"),
            "block_rows": int(cfg.get("block_rows", 0)),
            "namespaces": sorted(spaces),
        },
        "fork_shaped_s": (manifest.get("plane") or {}).get(
            "last_shaped_s"),
    }
    return (fork, arrays, counters, pending, ingress,
            manifest["node_ip"])


def _counters_summary(counters: dict | None, n_rows: int) -> dict:
    """Aggregate a per-row counter slice into the tenant_counters
    schema (the frozen `counters_at_restore` half of the failover
    accounting record)."""
    if counters is None:
        z = {k: 0.0 for k in
             ("tx_packets", "tx_bytes", "delivered_packets",
              "delivered_bytes", "dropped_loss", "dropped_queue",
              "dropped_ring", "corrupted")}
        z["links"] = n_rows
        return z

    def s(name: str) -> float:
        a = counters.get(name)
        return 0.0 if a is None else float(np.asarray(a).sum())

    return {
        "links": n_rows,
        "tx_packets": s("tx_packets"),
        "tx_bytes": s("tx_bytes"),
        "delivered_packets": s("rx_packets"),
        "delivered_bytes": s("rx_bytes"),
        "dropped_loss": s("dropped_loss"),
        "dropped_queue": s("dropped_queue"),
        "dropped_ring": s("dropped_ring"),
        "corrupted": s("rx_corrupted"),
    }


@guarded_by("_lock", "_watch", "_evacuations", "_evac_complete",
            "_fleet_slo")
class FleetSupervisor:
    """Health watcher + placement brain + failover/upgrade engine over
    one FederationController's registered planes. One supervisor per
    fleet; `attach()` wires it to every handle (and installs itself as
    `daemon.fleet`, the Local.FleetStatus / FleetUpgrade surface)."""

    def __init__(self, controller, ledger_root: str,
                 stats: FleetStats | None = None, chaos=None,
                 clock=time.monotonic,
                 suspect_after: int = 2, dead_after: int = 5,
                 healthy_after: int = 2) -> None:
        self.controller = controller
        self.ledger = PlacementLedger(ledger_root)
        self.stats = stats if stats is not None else FleetStats()
        self.chaos = chaos
        self.clock = clock
        self.suspect_after = int(suspect_after)
        self.dead_after = int(dead_after)
        self.healthy_after = int(healthy_after)
        self.log = get_logger("fleet")
        self._lock = threading.Lock()
        self._watch: dict[str, _PlaneWatch] = {}
        # newest sweep's fleet-merged SLO view (fleet_slo())
        self._fleet_slo: dict = {}
        self._evacuations: list[dict] = []
        # dead planes whose evacuation fully resolved (every tenant
        # restored, or unrecoverable for a PERMANENT reason): the
        # sweep loop retries the others until they land
        self._evac_complete: set[str] = set()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- wiring --------------------------------------------------------

    def attach(self, resume_orphans: bool = True) -> "FleetSupervisor":
        """Adopt the controller's current planes: create watches,
        install the `daemon.fleet` back-reference (the RPC surface),
        adopt ledger entries for tenants the ledger has never seen
        (registry is the live truth, the ledger its durable mirror),
        hook migration completions into the ledger, and resume any
        orphaned migration journals."""
        self.controller.placement_hook = self._on_migrated
        for name in self.controller.plane_names():
            self.watch_plane(name)
        if resume_orphans:
            self.resume_orphans()
        return self

    def watch_plane(self, name: str) -> None:
        """Start (or reset) watching one registered plane; adopts its
        registry's tenants into the ledger."""
        handle = self.controller.handle(name)
        handle.daemon.fleet = self
        with self._lock:
            self._watch.setdefault(name, _PlaneWatch())
        for t in handle.registry.list():
            if self.ledger.get(t.name) is None:
                self.ledger.assign(t.name, name, qos=t.qos)

    def mark_restarted(self, name: str) -> None:
        """Explicitly re-admit a plane (fresh process / upgrade): its
        watch resets to HEALTHY with clean counters. DEAD is final
        without this — a zombie must never silently resume serving
        tenants that were evacuated off it."""
        with self._lock:
            self._watch[name] = _PlaneWatch()
            self._evac_complete.discard(name)

    def _on_migrated(self, tenant: str, dst: str,
                     qos: str | None) -> None:
        self.ledger.assign(tenant, dst, qos=qos)

    # -- probing + suspicion state machine -----------------------------

    def probe(self, name: str) -> dict:
        """One health probe of a registered plane — the handle's
        `probe` hook (a gRPC Local.Health dial for out-of-process
        planes) or the in-process `daemon.health_snapshot()`. Raises
        on a dead plane; that raise IS the hard-failure signal."""
        if self.chaos is not None:
            self.chaos.on_probe(name)
        handle = self.controller.handle(name)
        self.stats.add(probes=1)
        if handle.probe is not None:
            return handle.probe()
        if getattr(handle.daemon, "chaos_dead", False):
            raise FleetError(f"plane {name} is not answering (killed)")
        return handle.daemon.health_snapshot()

    def _observe(self, name: str, health: dict | None,
                 error: str | None) -> str | None:
        """Feed one probe outcome into the suspicion machine. Returns
        the new state on a TRANSITION, else None."""
        with self._lock:
            w = self._watch[name]
            before = w.state
            if error is not None:
                w.consec_ok = 0
                w.consec_fail += 1
                w.last_error = error
                if (w.state == HEALTHY
                        and w.consec_fail >= self.suspect_after):
                    w.state = SUSPECT
                if (w.state == SUSPECT
                        and w.consec_fail >= self.dead_after):
                    w.state = DEAD
            elif health is not None and not health.get("serving", True):
                # soft: the plane ANSWERS but is degraded (bottom
                # ladder rung / watchdog stall) — suspicion yes, death
                # never: a responding plane still owns its state
                w.consec_fail = 0
                w.consec_ok = 0
                w.consec_soft += 1
                w.last_health = health
                w.last_error = "degraded (not serving)"
                if (w.state == HEALTHY
                        and w.consec_soft >= self.suspect_after):
                    w.state = SUSPECT
            else:
                w.consec_fail = 0
                w.consec_soft = 0
                w.consec_ok += 1
                w.last_ok_s = self.clock()
                w.last_health = health
                if (w.state == SUSPECT
                        and w.consec_ok >= self.healthy_after):
                    w.state = HEALTHY
                    w.last_error = None
            after = w.state
        if after != before:
            self.stats.add_transition(after)
            self.log.warning("plane state %s", _fields(
                plane=name, from_state=before, to_state=after,
                error=error))
            return after
        return None

    def sweep(self) -> dict:
        """One supervision pass: probe every watched plane, step the
        suspicion machine, and AUTOMATICALLY evacuate a plane the
        machine declares dead. O(planes) Python work + one probe per
        plane. Returns {plane: new_state} for this sweep's
        transitions."""
        self.stats.add(sweeps=1)
        with self._lock:
            names = sorted(self._watch)
        transitions: dict[str, str] = {}
        for name in names:
            with self._lock:
                state = self._watch[name].state
                evac_done = name in self._evac_complete
            if state == RESTARTING:
                continue
            if state == DEAD:
                # retry an evacuation that did not fully resolve
                # (transient failure, or a survivor that was itself
                # suspect at death time) — a DEAD plane is otherwise
                # never probed again, so the retry lives here
                if not evac_done:
                    self._try_evacuate(name)
                continue
            try:
                health = self.probe(name)
                tr = self._observe(name, health, None)
            except Exception as e:
                self.stats.add(probe_failures=1)
                tr = self._observe(name, None,
                                   f"{type(e).__name__}: {e}")
            if tr is not None:
                transitions[name] = tr
                if tr == DEAD:
                    self._try_evacuate(name)
        # refresh the fleet-merged SLO view (kubedtn_tpu_torch.slo.fleet):
        # per-plane verdicts + the migration journal's frozen window
        # slices, merged exactly on the shared bucket ladder — a
        # tenant migrated or evacuated mid-window keeps a CONTINUOUS
        # fleet-level attainment/budget series. O(planes·tenants);
        # failures never kill the sweep (a plane without telemetry or
        # tenancy simply contributes nothing).
        try:
            merged = self.fleet_slo()
            with self._lock:
                self._fleet_slo = merged
        except Exception:
            self.log.exception("fleet slo merge failed (continuing)")
        return transitions

    # -- fleet SLO view ------------------------------------------------

    def fleet_slo(self, tenant: str = "") -> dict:
        """The fleet-merged SLO verdicts: {tenant: merged verdict
        dict}. Live halves come from each non-dead plane's SLO
        evaluator (lazily attached when the plane has tenancy +
        telemetry); frozen halves from the migration journal's
        RECONCILE-frozen src window slices, so pre-move and post-move
        observation stitch into one continuous view. Served by
        Local.ObserveSLO(fleet=true) and refreshed every sweep."""
        from kubedtn_tpu_torch.slo import evaluator_for
        from kubedtn_tpu_torch.slo.fleet import fleet_slo as _merge

        with self._lock:
            names = [n for n, w in sorted(self._watch.items())
                     if w.state != DEAD]
        payloads: dict[str, list] = {}
        for name in names:
            try:
                handle = self.controller.handle(name)
            except MigrationError:
                continue
            ev = evaluator_for(handle.daemon)
            if ev is None:
                continue
            try:
                payloads[name] = ev.verdict_payloads(tenant=tenant)
            except Exception:
                self.log.exception("slo payload failed %s",
                                   _fields(plane=name))
        frozen = self.controller.frozen_windows(tenant=tenant)
        return _merge(payloads, frozen, tenant=tenant)

    def last_fleet_slo(self) -> dict:
        """The newest sweep's cached merge (empty before the first)."""
        with self._lock:
            return dict(self._fleet_slo)

    def _try_evacuate(self, name: str) -> None:
        try:
            self.evacuate(name)
        except Exception:
            # an evacuation failure must not kill the sweep loop;
            # the next sweep retries tenants still on the dead plane
            self.log.exception("evacuation failed (will retry) %s",
                               _fields(plane=name))

    def start(self, interval_s: float = 1.0) -> None:
        """Background sweep loop (the daemon's sidecar)."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sweep()
                except Exception:
                    self.log.exception("fleet sweep failed (continuing)")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="kdt-fleet-sweep")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
        self._thread = None

    # -- status --------------------------------------------------------

    def status(self) -> dict:
        placements = self.ledger.placements()
        placed_count: dict[str, int] = {}
        for t, p in placements.items():
            placed_count[p] = placed_count.get(p, 0) + 1
        cordoned = self.ledger.cordoned()
        snap = self.stats.snapshot()
        with self._lock:
            planes = []
            for name in sorted(self._watch):
                w = self._watch[name]
                planes.append({
                    "name": name,
                    "state": ("cordoned" if name in cordoned
                              and w.state == HEALTHY else w.state),
                    "consecutive_failures": w.consec_fail,
                    "last_error": w.last_error,
                    "tenants_placed": placed_count.get(name, 0),
                    "health": w.last_health,
                })
        return {
            "planes": planes,
            "placements": placements,
            "sweeps": snap["sweeps"],
            "evacuations": snap["evacuations"],
        }

    # -- orphaned migration journals -----------------------------------

    def resume_orphans(self) -> list[str]:
        """Resume every journaled migration left `running` by a crash
        or restart — no operator `kdt migrate --resume` needed. Records
        in `rolled_back` (an explicit abort) stay refused, per the
        migration contract; `done` records are finished. Returns the
        migration ids resumed."""
        root = self.controller.journal_root
        resumed = []
        for mid in journal.list_records(root):
            try:
                meta = journal.load_record_meta(root, mid)
            except journal.JournalError:
                continue
            if meta.get("state") != "running":
                continue
            try:
                self.controller.resume(mid)
            except (MigrationError, journal.JournalError) as e:
                self.log.warning("orphan resume failed %s", _fields(
                    migration=mid, error=f"{type(e).__name__}: {e}"))
                continue
            resumed.append(mid)
            self.stats.add(orphans_resumed=1)
            self.log.info("orphaned migration resumed %s",
                          _fields(migration=mid))
        return resumed

    # -- evacuation ----------------------------------------------------

    def _live_candidates(self, exclude: set[str]) -> tuple[dict, dict]:
        """(healths, placed) over currently-HEALTHY planes outside
        `exclude` — the placement inputs."""
        cordoned = self.ledger.cordoned()
        healths: dict[str, dict] = {}
        with self._lock:
            names = [n for n, w in self._watch.items()
                     if w.state == HEALTHY]
        for name in names:
            if name in exclude or name in cordoned:
                continue
            try:
                healths[name] = self.probe(name)
            except Exception:
                self.stats.add(probe_failures=1)
                continue
        placements = self.ledger.placements()
        placed: dict[str, list[str]] = {}
        for t, p in placements.items():
            placed.setdefault(p, []).append(t)
        return healths, placed

    def _resolve_migrations(self, dead: str,
                            record: dict) -> tuple[dict, dict]:
        """Resolve every in-flight migration touching the dead plane
        per the migration crash contract. Returns (overrides,
        fallbacks):
        tenant → (fork, arrays, counters, pending, ingress, src_addr)
        restore sources. `overrides` WIN over the checkpoint (a
        pre-cutover fork of a held tenant is the authoritative
        capture); `fallbacks` are consulted only when the dead plane's
        checkpoint has no trace of the tenant (post-cutover dst death
        where the dst checkpoint predates the restore — a NEWER dst
        checkpoint carries post-cutover state the stale fork does
        not)."""
        root = self.controller.journal_root
        overrides: dict[str, tuple] = {}
        fallbacks: dict[str, tuple] = {}
        for mid in journal.list_records(root):
            try:
                meta = journal.load_record_meta(root, mid)
            except journal.JournalError:
                continue
            if meta.get("state") != "running":
                continue
            if dead not in (meta.get("src"), meta.get("dst")):
                continue
            tenant = meta["tenant"]
            steps = meta.get("steps_done", [])
            if "cutover" not in steps:
                # pre-cutover: src is authoritative
                if meta["dst"] == dead:
                    # dst died mid-restore: nothing on dst survives a
                    # SIGKILL anyway; src keeps serving — release the
                    # throttle hold and abort the record
                    action = ("rolled back: dst died pre-cutover; "
                              "src stays authoritative")
                    try:
                        self.controller.handle(meta["src"]) \
                            .registry.release_hold(tenant)
                    except MigrationError:
                        pass
                else:
                    # src died: the journal's FORK capture (if it
                    # committed) is the newest crash-consistent state
                    # — re-fork elsewhere; partial dst state from an
                    # interrupted RESTORE is discarded first
                    if "fork" in steps:
                        try:
                            full, arrays = journal.load_record(root,
                                                               mid)
                        except journal.JournalError:
                            full, arrays = None, None
                        if full is not None:
                            fork = full["fork"]
                            try:
                                dst_h = self.controller.handle(
                                    meta["dst"])
                                discard_partial_restore(dst_h, tenant,
                                                        fork)
                            except MigrationError:
                                pass
                            try:
                                src_addr = self.controller.handle(
                                    dead).addr
                            except Exception:
                                src_addr = ""
                            overrides[tenant] = (
                                fork, arrays,
                                fork.get("counters_at_fork"), [], [],
                                src_addr)
                    action = ("rolled back: src died pre-cutover; "
                              "re-forking from the journal capture "
                              "onto a survivor")
                meta["state"] = "rolled_back"
                meta["failover"] = dead
                journal.save_record(root, mid, meta)
            else:
                # post-cutover: roll forward — dst owns the tenant
                if meta["dst"] == dead:
                    # dst died owning the tenant: the journal fork is
                    # the roll-forward source when dst's checkpoint
                    # predates the restore (tenant absent there); the
                    # alive src still holds the released-but-unfreed
                    # slice — finish RELEASE on it
                    try:
                        co = self.controller.coordinator(mid)
                        co._step_release()
                        # the release committed a new journal
                        # generation: re-read so the terminal write
                        # below keeps its steps_done entry
                        meta = journal.load_record_meta(root, mid)
                    except Exception:
                        self.log.exception(
                            "src release during failover failed %s",
                            _fields(migration=mid))
                    try:
                        full, arrays = journal.load_record(root, mid)
                        try:
                            src_addr = self.controller.handle(
                                dead).addr
                        except Exception:
                            src_addr = ""
                        fallbacks.setdefault(
                            tenant,
                            (full["fork"], arrays,
                             full["fork"].get("counters_at_fork"),
                             [], [], src_addr))
                    except journal.JournalError:
                        pass
                    # the tenant was placed on the (dead) dst from
                    # cutover on — make the ledger agree so the
                    # evacuation pass picks it up
                    self.ledger.assign(tenant, dead)
                    action = ("rolled forward: dst died post-cutover; "
                              "evacuating the cut-over slice")
                else:
                    # src died post-cutover: dst serves; release its
                    # hold (reconcile would have) and close the record
                    # — the src accounting slice died with src, which
                    # the record states instead of hiding
                    try:
                        dst_h = self.controller.handle(meta["dst"])
                        dst_h.registry.release_hold(tenant)
                        self.ledger.assign(tenant, meta["dst"])
                    except MigrationError:
                        pass
                    action = ("rolled forward: src died post-cutover; "
                              "dst serves (src accounting slice lost "
                              "with the plane)")
                meta["state"] = "done"
                meta["failover"] = dead
                journal.save_record(root, mid, meta)
            record["migrations_resolved"].append(
                {"id": mid, "tenant": tenant, "action": action})
            self.log.warning("migration resolved by failover %s",
                             _fields(migration=mid, action=action))
        return overrides, fallbacks

    def evacuate(self, dead: str) -> dict:
        """Cold-restore every tenant of a DEAD plane onto survivors —
        the no-operator failover path. Restore source per tenant: an
        in-flight migration's journal fork when the crash contract says
        so, else the dead plane's last crash-consistent checkpoint.
        Rows land byte-identical to the source generation (the
        restore-slice contract), cumulative counters ride with them,
        and checkpointed in-flight frames complete their remaining
        delays on the survivor. Returns the evacuation record."""
        with self._lock:
            w = self._watch.setdefault(dead, _PlaneWatch())
            w.state = DEAD
        record: dict = {"plane": dead, "at_s": time.time(),
                        "tenants": {}, "migrations_resolved": []}
        overrides, fallbacks = self._resolve_migrations(dead, record)
        handle = self.controller.handle(dead)
        names = set(self.ledger.on_plane(dead))
        ckpt_dir = handle.checkpoint_dir
        # the dead plane's checkpoint, resolved once for the whole
        # evacuation (each tenant's slice reuses its manifest)
        gen = None
        if ckpt_dir:
            try:
                gen = ckpt.Generation(ckpt_dir)
                for t in (gen.manifest.get("tenancy") or {}).get(
                        "tenants", ()):
                    names.add(t["name"])
            except ckpt.CheckpointError:
                pass
        healths, placed = self._live_candidates(exclude={dead})
        complete = True
        for tenant in sorted(names):
            placed_on = self.ledger.get(tenant)
            if placed_on is not None and placed_on != dead:
                # already living elsewhere — a tenant an earlier
                # (partial) evacuation pass restored, or one the
                # checkpoint remembers but a later migration moved
                # off; re-restoring would double-serve it
                continue
            entry: dict = {"source": None, "survivor": None}
            try:
                src = overrides.get(tenant)
                if src is not None:
                    entry["source"] = "journal-fork"
                elif ckpt_dir:
                    # the checkpoint wins when it knows the tenant (it
                    # may be NEWER than a fallback fork — post-cutover
                    # state); the journal fork covers the gap where it
                    # predates the restore
                    try:
                        src = fork_from_checkpoint(gen or ckpt_dir,
                                                   tenant)
                        entry["source"] = "checkpoint"
                    except (FleetError, ckpt.CheckpointError):
                        src = fallbacks.get(tenant)
                        if src is None:
                            raise
                        entry["source"] = "journal-fork"
                else:
                    src = fallbacks.get(tenant)
                    if src is not None:
                        entry["source"] = "journal-fork"
                if src is None:
                    raise FleetError(
                        f"no durable state for tenant {tenant!r} "
                        f"(no checkpoint dir configured)")
                fork, arrays, counters, pending, ingress, src_addr = \
                    src
                survivor = choose_plane(
                    healths, placed, self.ledger.qos_of,
                    exclude={dead})
                sh = self.controller.handle(survivor)
                rows = restore_tenant_slice(
                    sh, tenant, fork, arrays, src_addr, hold=False)
                n_pending = 0
                if pending:
                    now_s = (sh.plane.last_now_s
                             if sh.plane._clock_ext else None)
                    if sh.plane._clock_ext and now_s is None:
                        self.log.warning(
                            "pending frames skipped (no clock) %s",
                            _fields(tenant=tenant))
                    else:
                        n_pending = sh.plane.restore_pending(
                            pending, now_s=now_s)
                n_ingress = 0
                for pk, uid, frame in ingress:
                    w = sh.daemon.wires.get_by_key(pk, int(uid))
                    if w is not None:
                        w.ingress.append(frame)
                        n_ingress += 1
                self.ledger.assign(tenant, survivor,
                                   qos=fork["registry"].get("qos"))
                placed.setdefault(survivor, []).append(tenant)
                # the src half of the failover accounting, FROZEN here
                # exactly like RECONCILE freezes the src counter slice:
                # the durable checkpoint counters (per-row slice), or
                # the fork's captured tenant_counters for a
                # journal-fork source
                if isinstance(counters, dict) and \
                        "delivered_packets" in counters:
                    at_restore = dict(counters)
                else:
                    at_restore = _counters_summary(counters, len(rows))
                entry.update({
                    "survivor": survivor,
                    "rows": len(rows),
                    "pending_restored": n_pending,
                    "ingress_restored": n_ingress,
                    "counters_at_restore": at_restore,
                })
                self.stats.add(evacuated_tenants=1,
                               evacuated_rows=len(rows),
                               pending_restored=n_pending + n_ingress)
                self.log.warning("tenant evacuated %s", _fields(
                    tenant=tenant, from_plane=dead, to_plane=survivor,
                    rows=len(rows), source=entry["source"]))
            except (FleetError, PlacementError, MigrationError,
                    ckpt.CheckpointError) as e:
                # NEVER hidden: a tenant that could not be restored is
                # recorded with the reason (its whole slice is the
                # reported loss)
                entry["error"] = f"{type(e).__name__}: {e}"
                self.log.error("tenant evacuation failed %s", _fields(
                    tenant=tenant, plane=dead, error=entry["error"]))
                # PERMANENT: no durable state can ever appear for this
                # incarnation. Everything else (no survivor yet, a
                # transient restore failure) is retried next sweep.
                if "no durable state" not in str(e):
                    complete = False
            record["tenants"][tenant] = entry
        self.stats.add(evacuations=1)
        with self._lock:
            self._evacuations.append(record)
            if complete:
                self._evac_complete.add(dead)
        return record

    def evacuations(self) -> list[dict]:
        with self._lock:
            return list(self._evacuations)

    def check_failover_accounting(self, tenant: str,
                                  fed_frames: int) -> dict:
        """The failover extension of the migration accounting rule: every
        fed frame is delivered by the dead plane BEFORE its last
        checkpoint (durable counters, restored with the rows),
        delivered by the survivor after it, or REPORTED lost:

            fed == delivered_src + delivered_dst + reported_lost

        `reported_lost` is derived (fed − accounted-terminal) and the
        mismatch gauge carries any OVER-accounting — internal counters
        explaining more frames than were fed means a duplicate-
        delivery bug, which must read 0 in every scenario. Extends the
        `kubedtn_migration_accounting_mismatch` discipline to
        failover (the same gauge is updated). The src half is the
        FROZEN `counters_at_restore` slice; the dst half is the
        survivor's live counters (its restored rows started at zero,
        so frozen + live never double-counts)."""
        ev = None
        with self._lock:
            for rec in reversed(self._evacuations):
                e = rec["tenants"].get(tenant)
                if e is not None and e.get("survivor"):
                    ev = e
                    break
        if ev is None:
            raise FleetError(
                f"no completed evacuation covers tenant {tenant!r}")
        sh = self.controller.handle(ev["survivor"])
        live = sh.registry.tenant_counters(sh.plane, tenant)
        at_restore = ev["counters_at_restore"]
        accounted = (MigrationCoordinator._accounted(live)
                     + MigrationCoordinator._accounted(at_restore))
        delivered_src = float(at_restore["delivered_packets"])
        delivered_dst = float(live["delivered_packets"])
        raw = float(fed_frames) - accounted
        reported_lost = max(0.0, raw)
        mismatch = max(0.0, -raw)
        self.controller.stats.set_mismatch(mismatch)
        self.stats.set_reported_lost(reported_lost)
        return {
            "fed": int(fed_frames),
            "accounted": accounted,
            "delivered_src": delivered_src,
            "delivered_dst": delivered_dst,
            "reported_lost": reported_lost,
            "mismatch": mismatch,
        }

    # -- rebalance + rolling upgrade -----------------------------------

    def rebalance(self, settle=None) -> list[dict]:
        """Execute the placement policy's rebalance plan as live
        migrations (each one the full zero-loss migration state
        machine)."""
        from kubedtn_tpu_torch.federation.placement import rebalance_plan

        healths, placed = self._live_candidates(exclude=set())
        moves = rebalance_plan(healths, placed, self.ledger.qos_of,
                               exclude=self.ledger.cordoned())
        out = []
        for tenant, src, dst in moves:
            rec = self.controller.migrate(tenant, src, dst,
                                          settle=settle)
            self.ledger.assign(tenant, dst)
            out.append({"tenant": tenant, "src": src, "dst": dst,
                        "state": rec["state"]})
        return out

    def rolling_upgrade(self, planes: list[str] | None = None,
                        verify_probes: int | None = None,
                        verify_timeout_s: float = 30.0,
                        settle=None) -> dict:
        """Upgrade the fleet one plane at a time with zero frame loss:
        cordon → drain every tenant via live migration → restart the
        daemon binary (the handle's `restarter` hook) → health-verify
        (`verify_probes` consecutive clean probes) → refill the
        drained tenants → uncordon → next plane. A plane with no
        restarter, or no healthy survivor to drain to, is reported and
        skipped — never half-drained."""
        need = int(verify_probes or self.healthy_after)
        if planes is None:
            with self._lock:
                planes = [n for n in sorted(self._watch)
                          if self._watch[n].state == HEALTHY]
        reports = []
        migrations = 0
        for name in planes:
            report = {"plane": name, "drained_tenants": [],
                      "refilled_tenants": [], "restarted": False,
                      "healthy": False, "error": ""}
            reports.append(report)
            try:
                handle = self.controller.handle(name)
            except MigrationError as e:
                report["error"] = str(e)
                continue
            if handle.restarter is None:
                report["error"] = (f"plane {name} has no restarter "
                                   f"configured")
                continue
            healths, placed = self._live_candidates(exclude={name})
            if not healths:
                report["error"] = (f"no healthy survivor to drain "
                                   f"{name} into")
                continue
            self.ledger.cordon(name)
            with self._lock:
                self._watch[name].state = RESTARTING
            try:
                # drain: every tenant moves off via live migration
                moved: dict[str, str] = {}
                for t in sorted(t.name for t in
                                handle.registry.list()):
                    dst = choose_plane(healths, placed,
                                       self.ledger.qos_of,
                                       exclude={name})
                    self.controller.migrate(t, name, dst,
                                            settle=settle)
                    self.ledger.assign(t, dst)
                    placed.setdefault(dst, []).append(t)
                    moved[t] = dst
                    migrations += 1
                    report["drained_tenants"].append(t)
                # restart the daemon binary
                new_handle = handle.restarter()
                self.controller.register(new_handle)
                new_handle.daemon.fleet = self
                report["restarted"] = True
                # health-verify BEFORE refill: `need` consecutive
                # clean serving probes
                ok = 0
                deadline = self.clock() + verify_timeout_s
                while ok < need:
                    try:
                        h = self.probe(name)
                        ok = ok + 1 if h.get("serving", False) else 0
                    except Exception:
                        self.stats.add(probe_failures=1)
                        ok = 0
                    if ok >= need:
                        break
                    if self.clock() > deadline:
                        raise FleetError(
                            f"plane {name} failed health "
                            f"verification after restart")
                    if settle is not None:
                        settle()
                    else:
                        time.sleep(0.05)
                report["healthy"] = True
                self.mark_restarted(name)
                self.ledger.uncordon(name)
                # refill: the drained tenants come home, each again a
                # zero-loss live migration
                for t in sorted(moved):
                    self.controller.migrate(t, moved[t], name,
                                            settle=settle)
                    self.ledger.assign(t, name)
                    migrations += 1
                    report["refilled_tenants"].append(t)
            except (FleetError, PlacementError, MigrationError) as e:
                report["error"] = f"{type(e).__name__}: {e}"
                # cordon stays if the plane never verified healthy —
                # placement must not target a plane in an unknown
                # state. The WATCH must not stay parked in
                # `restarting` either, or the suspicion machine would
                # never probe the plane again (a later real death
                # would go undetected): a plane that never restarted
                # is still the old serving process (back to healthy
                # watching), a restarted-but-unverified one is suspect
                # until clean probes clear it.
                with self._lock:
                    self._watch[name].state = (
                        SUSPECT if report["restarted"] else HEALTHY)
                continue
        self.stats.add(upgrades=1, upgrade_migrations=migrations)
        self.log.info("rolling upgrade finished %s", _fields(
            planes=len(reports), migrations=migrations,
            errors=sum(1 for r in reports if r["error"])))
        return {"reports": reports, "migrations": migrations,
                "frames_lost_known": True}
