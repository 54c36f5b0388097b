"""Federated planes — zero-loss live tenant migration.

Many daemons, each a (sharded, multi-tenant) serving plane; a
placement layer moves TENANTS between them while both planes keep
serving. The headline is the crash-safe migration state machine:

    MIGRATE(tenant, src → dst) =
        THROTTLE → FORK → RESTORE → CUTOVER → RECONCILE → RELEASE

- **THROTTLE** — clamp the tenant's admission on src (a migration
  hold: its wires drain budget 0, frames queue — never dropped — and
  the daemon's ingress high-water backpressure bounds the backlog).
- **FORK** — capture the tenant's slice at a src tick-lock flush
  barrier (the `twin/snapshot` consistency contract: every in-flight
  dispatch lands first, the runner pauses one barrier, zero live-frame
  loss): per-row edge state bit-exact, link identities, peer map,
  topology records, wire definitions, quotas/QoS/block entitlement.
- **RESTORE** — replay onto dst at a dst barrier: tenant registered
  with its quotas and `block_rows` entitlement (rows carve into the
  tenant's contiguous block via `partition.tenant_blocks`), rows
  adopted bit-exact (identity-keyed PRNG streams — `link_key_id` —
  migrate with the link, not the row number), wires re-created (a
  cross-node wire whose peer IS dst becomes a local wire), store
  records moved. The tenant stays HELD on dst until cutover commits.
- **CUTOVER** — make-before-break at a src barrier: every queued
  tenant ingress entry transfers to the dst wire in FIFO order, then a
  redirect is installed on each src wire (late producers' frames
  forward the moment they land) — new frames land on dst while src's
  in-flight frames (delay line, holdback, `_PeerSender` outage
  buffers) drain through src.
- **RECONCILE** — release the dst hold, drain src residuals to zero
  (ingress, holdback, dispatches in flight, delay line, peer egress
  buffers — breaker-aware:
  an OPEN src→peer breaker extends the wait to its next half-open
  probe instead of failing the migration), then snapshot the
  byte-exact accounting split: delivered_src from the src counter
  slice (and the telemetry window rings), delivered_dst live on dst;
  `fed == delivered_src + delivered_dst` is the invariant
  `check_accounting` (and kubedtn_migration_accounting_mismatch) pins.
- **RELEASE** — free the src block: rows abandoned, wires deleted,
  store records dropped, tenant deregistered (`TenantRegistry.delete`).

Crash contract (journal.py persists the record after each step with
checkpoint-grade atomicity): **before CUTOVER commits, src is
authoritative** — resume discards the partial dst state bit-exactly
(rows abandoned, transferred frames moved back to the FRONT of the src
queues in order) and re-runs from a fresh FORK, so the tenant's stream
is byte-identical to a never-migrated plane; **after CUTOVER commits,
the migration rolls forward** — RECONCILE and RELEASE are idempotent
and re-run to completion. Either way `frames_lost == 0`.

Byte-identity scope: the delivered stream equals the never-migrated
reference when the federation's planes share a PRNG seed and tick in
lockstep (same dispatch schedule — the same alignment the cohabited ≡
solo tenancy contract already requires; tests/test_torch_federation.py
pins it at pipeline depths 1 and 2). Unaligned planes still get zero
loss and exact accounting; the streams are then statistically, not
bitwise, identical.

Port of kubedtn_tpu/federation/migrate.py. The record, the journal
format and the step semantics are the JAX package's; what differs is
where the state lives:

- the fork gathers the tenant's rows from the engine's tensors with one
  `index_select` per column (on the engine's device), after the engine
  flush, and copies them to the host;
- the restore writes the dynamic columns into the destination engine's
  tensors IN PLACE (`index_copy_`), after flushing the init scatter that
  `adopt_rows` only enqueued — written the other way round, the pending
  init would land last and every adopted row would restart from a fresh
  bucket. The clock rebase is computed in float64 from the two planes'
  shaped clocks and cast to float32 once, as in the JAX package;
- the plane's cumulative counters are host float32 numpy columns here,
  zeroed in place on the adopted rows under the destination's barrier;
- RECONCILE's residue counts the tenant's frames in the plane's
  delay-line batches (`_pending`); the port has no heap fallback of the
  release (it requires the native timing wheel), so there is nothing
  else to count.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np
import torch

from kubedtn_tpu_torch import fault
from kubedtn_tpu_torch.contracts import guarded_by
from kubedtn_tpu_torch.federation import journal
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

STEPS = ("throttle", "fork", "restore", "cutover", "reconcile",
         "release")


class MigrationError(RuntimeError):
    """A migration step could not complete (resumable via `resume`)."""


@guarded_by("_lock", "attempts", "completed", "rolled_back", "resumed",
            "bytes_reconciled", "accounting_mismatch", "step_seconds")
class MigrationStats:
    """Cumulative migration counters for the kubedtn_migration_*
    Prometheus series (metrics.MigrationStatsCollector)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.attempts = 0
        self.completed = 0
        self.rolled_back = 0
        self.resumed = 0
        self.bytes_reconciled = 0.0
        # GAUGE: |fed - (delivered_src + delivered_dst)| of the latest
        # accounting check — the alert-worthy number; stays 0 in every
        # scenario
        self.accounting_mismatch = 0.0
        self.step_seconds = {s: 0.0 for s in STEPS}

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def add_step_seconds(self, step: str, s: float) -> None:
        with self._lock:
            self.step_seconds[step] = self.step_seconds.get(step, 0.0) + s

    def set_mismatch(self, v: float) -> None:
        with self._lock:
            self.accounting_mismatch = float(v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "attempts": self.attempts,
                "completed": self.completed,
                "rolled_back": self.rolled_back,
                "resumed": self.resumed,
                "bytes_reconciled": self.bytes_reconciled,
                "accounting_mismatch": self.accounting_mismatch,
                "step_seconds": dict(self.step_seconds),
            }


def stats_for(daemon) -> MigrationStats:
    """The per-daemon MigrationStats sink (created on first use) —
    the pattern updates.stager.stats_for set."""
    stats = getattr(daemon, "_migration_stats", None)
    if stats is None:
        stats = daemon._migration_stats = MigrationStats()
    return stats


@dataclasses.dataclass
class PlaneHandle:
    """One federation member: a daemon with its live plane and tenant
    registry. `addr` is the daemon's wire address (used to turn a
    cross-node wire whose peer IS the destination into a local wire
    at restore).

    The three optional fields are the fleet supervisor's hooks
    (federation.supervisor): `checkpoint_dir` names the plane's
    crash-consistent checkpoint (the cold-restore source when the
    plane dies), `probe` overrides the health probe (default: the
    in-process `daemon.health_snapshot()`; a gRPC Local.Health dial
    for planes in other processes), and `restarter` performs the
    plane's binary restart for `kdt fleet upgrade` (checkpoint →
    teardown → rebuild → new server) and returns the REPLACEMENT
    handle."""

    name: str
    daemon: object        # wire.server.Daemon
    plane: object         # runtime.WireDataPlane
    registry: object      # tenancy.TenantRegistry
    checkpoint_dir: str | None = None
    probe: object = None       # () -> health dict; raises when dead
    restarter: object = None   # () -> PlaneHandle (the replacement)

    @property
    def engine(self):
        return self.daemon.engine

    @property
    def store(self):
        return self.engine.store

    @property
    def addr(self) -> str:
        return self.engine.node_ip


def restore_tenant_slice(dst: PlaneHandle, tenant: str, fork: dict,
                         arrays: dict, src_addr: str,
                         hold: bool = True):
    """Replay a captured tenant slice onto `dst` at ONE stage barrier:
    tenant registered with its quotas and block entitlement, topologies
    recreated with placement moved to dst, rows adopted bit-exact
    (identity-keyed PRNG streams ride the link identity), dynamic
    shaping columns scattered with the clock columns rebased by the
    capture→dst shaped-gap, wires re-created (a cross-node wire whose
    peer IS dst becomes local). The ONE restore implementation — the
    migration RESTORE step replays a live fork through it (tenant HELD
    until cutover commits), and the fleet supervisor's evacuation
    replays a checkpoint/journal slice through it (hold=False: the dead
    plane cannot cut over, the survivor serves immediately).

    The slice's cumulative delivery counters do NOT scatter in: the
    failover accounting freezes them as the src half of the record
    (federation.supervisor) exactly like RECONCILE freezes the src
    counter slice — the survivor's live counters stay purely its own,
    so `frozen + live` explains the feed without double counting.
    Takes dst's stage barrier itself (re-entrant under the tick lock,
    so the coordinator's own barrier composes). Returns the adopted
    row list."""
    return dst.plane.stage_update_round(
        lambda: _restore_slice_locked(dst, tenant, fork, arrays,
                                      src_addr, hold))


def _restore_slice_locked(dst: PlaneHandle, tenant: str, fork: dict,
                          arrays: dict, src_addr: str, hold: bool):
    cfg = fork["registry"]
    reg_d = dst.registry
    reg_d.create(tenant, qos=cfg["qos"],
                 frame_budget_per_s=cfg["frame_budget_per_s"],
                 byte_budget_per_s=cfg["byte_budget_per_s"],
                 block_edges=int(cfg["block_rows"]),
                 namespaces=cfg["namespaces"])
    if hold:
        # held until CUTOVER commits: dst must not shape a single
        # tenant frame while a pre-cutover rollback is still legal
        reg_d.hold(tenant)
    from kubedtn_tpu_torch.api.types import Topology
    from kubedtn_tpu_torch.topology.store import NotFoundError

    for rec in fork["topologies"]:
        meta = rec["manifest"]["metadata"]
        ns = meta.get("namespace", "default")
        name = meta["name"]
        try:
            dst.store.get(ns, name)
        except NotFoundError:
            topo = Topology.from_manifest(rec["manifest"])
            # placement moves with the tenant: the pod now lives on
            # dst (link ops realized here from now on)
            if topo.status.src_ip == src_addr:
                topo.status.src_ip = dst.addr
            dst.store.create(topo)
            dst.engine.set_alive(name, ns, dst.addr,
                                 topo.status.net_ns
                                 or f"/run/netns/{name}")
    entries = []
    props = np.asarray(arrays["props"], np.float32)
    for i, (pod_key, uid, sname, dname, shaped) in enumerate(
            fork["identities"]):
        entries.append((pod_key, int(uid), sname, dname,
                        props[i], bool(shaped)))
    peers = [((a, int(b)), (c, int(d)))
             for a, b, c, d in fork["peers"]]
    rows = dst.engine.adopt_rows(entries, peers=peers)
    # dynamic shaping state lands bit-exact; the clock columns are
    # rebased by the wall gap between the capture barrier and dst's
    # newest shaped tick (exactly the rolls dst's own dispatches did
    # NOT apply to these rows — 0, hence verbatim bits, when the
    # planes tick in lockstep). The floored max composes with
    # _roll_clocks' sequential maxes: max(max(x-a,f)-b,f) ==
    # max(x-(a+b),f).
    fork_shaped = fork.get("fork_shaped_s")
    dst_shaped = dst.plane._last_shaped_s
    delta_us = np.float32(0.0)
    if fork_shaped is not None and dst_shaped is not None:
        delta_us = np.float32(
            max(0.0, (dst_shaped - fork_shaped) * 1e6))
    floor = np.float32(-1e7)
    t_last = np.maximum(
        np.asarray(arrays["t_last"], np.float32) - delta_us, floor)
    backlog = np.maximum(
        np.asarray(arrays["backlog_until"], np.float32) - delta_us,
        floor)
    engine = dst.engine
    with engine._lock:
        # adopt_rows only ENQUEUED the rows' init scatter: it must land
        # before the captured dynamics, or it would overwrite them
        engine._flush_device_locked()
        st = engine._state
        ri = torch.as_tensor(np.asarray(rows, np.int64),
                             device=st.device)
        for name, vals in (("tokens", arrays["tokens"]),
                           ("t_last", t_last),
                           ("corr", arrays["corr"]),
                           ("pkt_count", arrays["pkt_count"]),
                           ("backlog_until", backlog)):
            col = getattr(st, name)
            col.index_copy_(0, ri, torch.as_tensor(
                np.asarray(vals), dtype=col.dtype, device=col.device))
    # the adopted rows' plane counters start from ZERO here: a reused
    # row must not leak its previous occupant's history into the
    # tenant's slice (migration RECONCILE and failover accounting both
    # sum the frozen src slice + this plane's live slice, so residue
    # would read as phantom delivery)
    plane = dst.plane
    cnt = plane.counters
    cap = int(cnt.tx_packets.shape[0])
    rz = [r for r in rows if r < cap]
    if rz:
        # host float32 columns, zeroed in place: the caller holds dst's
        # tick lock (the stage barrier), which every counter write takes
        rn = np.asarray(rz, np.int64)
        for f in dataclasses.fields(type(cnt)):
            getattr(cnt, f.name)[rn] = 0.0
    # wires: a cross-node wire whose peer IS dst becomes local (the
    # frames that used to ride the src→dst gRPC hop now deliver on
    # dst directly); third-party peers are kept
    from kubedtn_tpu_torch.wire.server import Wire

    for pod_key, uid, peer_ip, peer_intf_id, ifname in fork["wires"]:
        peer = "" if peer_ip == dst.addr else peer_ip

        def build(wire_id: int, _pk=pod_key, _uid=uid,
                  _peer=peer, _pid=peer_intf_id, _if=ifname):
            return Wire(wire_id=wire_id, uid=int(_uid),
                        pod_key=_pk, node_iface_name=_if,
                        peer_intf_id=int(_pid), peer_ip=_peer)

        dst.daemon.wires.get_or_create(pod_key, int(uid), build)
    return rows


def discard_partial_restore(dst: PlaneHandle, tenant: str,
                            fork: dict) -> None:
    """Remove everything a RESTORE may have left on `dst` for this
    fork: exactly the fork-captured rows / wires / store records and
    the tenant registration — never a neighbor wire that merely shares
    the namespace. Safe however little actually landed (every sub-step
    checks). The dst half of the pre-cutover crash contract, shared by
    the coordinator's `_undo_partial` and the fleet supervisor's
    resolution of a migration whose SRC died (the partial dst state is
    discarded before the evacuation re-restores from the journal
    fork)."""
    from kubedtn_tpu_torch.topology.store import NotFoundError

    keys = [(pk, int(uid)) for pk, uid, *_rest in fork["identities"]]

    def _drop():
        return dst.engine.abandon_rows(keys)

    dst.plane.stage_update_round(_drop)
    # exactly the wires RESTORE creates (the fork capture) — never a
    # neighbor wire that merely shares the namespace on dst (e.g. the
    # peer-side wires of the tenant's cross-node links)
    for pod_key, uid, _peer_ip, _pid, _if in fork["wires"]:
        dst.daemon.wires.delete_by_key(pod_key, int(uid))
    for rec in fork["topologies"]:
        ns = rec["manifest"]["metadata"].get("namespace", "default")
        name = rec["manifest"]["metadata"]["name"]
        try:
            dst.store.get(ns, name)
        except NotFoundError:
            continue
        try:
            # clears placement + our finalizer so delete() completes
            dst.engine.set_alive(name, ns, "", "")
            dst.store.delete(ns, name)
        except NotFoundError:
            pass
    dst.registry.release_hold(tenant)
    dst.registry.delete(tenant)


@guarded_by("_lock", "_record")
class MigrationCoordinator:
    """One tenant's migration src → dst, journaled step by step.

    Single-writer: one thread drives migrate()/resume()/rollback();
    `_lock` guards the record against concurrent status() readers
    (`_fork_arrays` is deliberately unannotated — written only by the
    single driving thread, never read concurrently). Everything that
    touches a live plane goes through that plane's
    `stage_update_round` barrier (the planned-update staging
    discipline), so no tick ever shapes against a half-applied
    migration step."""

    def __init__(self, tenant: str, src: PlaneHandle, dst: PlaneHandle,
                 journal_root: str, migration_id: str,
                 stats: MigrationStats | None = None, chaos=None,
                 settle=None, reconcile_timeout_s: float = 30.0) -> None:
        self.tenant = tenant
        self.src = src
        self.dst = dst
        self.journal_root = journal_root
        self.migration_id = migration_id
        self.stats = stats if stats is not None else MigrationStats()
        self.chaos = chaos
        # called between RECONCILE polls: explicit-clock embedders tick
        # their planes here; default is a real-time sleep
        self.settle = settle
        self.reconcile_timeout_s = reconcile_timeout_s
        self.log = get_logger("federation")
        self._lock = threading.Lock()
        self._record: dict = {
            "migration_id": migration_id,
            "tenant": tenant,
            "src": src.name,
            "dst": dst.name,
            "state": "running",      # running | done | rolled_back
            "steps_done": [],
            "resumed": 0,
            "rollbacks": 0,
            "step_seconds": {},
            "started_s": time.time(),
        }
        self._fork_arrays: dict | None = None

    # -- record plumbing ----------------------------------------------

    @classmethod
    def from_journal(cls, journal_root: str, migration_id: str,
                     handles: dict, **kw) -> "MigrationCoordinator":
        """Rebuild a coordinator from a committed record (daemon
        restart). `handles` maps plane name → PlaneHandle."""
        record, arrays = journal.load_record(journal_root, migration_id)
        src = handles[record["src"]]
        dst = handles[record["dst"]]
        co = cls(record["tenant"], src, dst, journal_root, migration_id,
                 **kw)
        co._record = record
        co._fork_arrays = arrays
        return co

    def record(self) -> dict:
        with self._lock:
            rec = dict(self._record)
            rec["steps_done"] = list(self._record["steps_done"])
            return rec

    def _commit(self, step: str | None = None, arrays: dict | None = None,
                **payload) -> None:
        """Update the record (marking `step` done when given) and
        journal it atomically — the step is committed only once this
        returns."""
        with self._lock:
            self._record.update(payload)
            if step is not None and step not in \
                    self._record["steps_done"]:
                self._record["steps_done"].append(step)
            record = dict(self._record)
            record["steps_done"] = list(self._record["steps_done"])
        journal.save_record(self.journal_root, self.migration_id,
                            record, arrays=arrays)

    def _chaos_step(self, step: str) -> None:
        if self.chaos is not None:
            self.chaos.on_migration_step(step)

    # -- drive --------------------------------------------------------

    def migrate(self) -> dict:
        """Run the state machine to completion from its current
        journaled position. Raises on an injected/real failure; the
        journal then resumes via `resume()`."""
        self.stats.add(attempts=1)
        return self._run_steps()

    def _run_steps(self) -> dict:
        fns = {"throttle": self._step_throttle, "fork": self._step_fork,
               "restore": self._step_restore,
               "cutover": self._step_cutover,
               "reconcile": self._step_reconcile,
               "release": self._step_release}
        for step in STEPS:
            with self._lock:
                done = step in self._record["steps_done"]
            if done:
                continue
            t0 = time.perf_counter()
            fns[step]()
            dt = time.perf_counter() - t0
            self.stats.add_step_seconds(step, dt)
            with self._lock:
                ss = self._record["step_seconds"]
                ss[step] = ss.get(step, 0.0) + dt
        self._commit(state="done", finished_s=time.time())
        self.stats.add(completed=1)
        out = self.record()
        self.log.info("migration done %s", _fields(
            id=self.migration_id, tenant=self.tenant,
            src=self.src.name, dst=self.dst.name,
            resumed=out["resumed"]))
        return out

    def resume(self) -> dict:
        """Continue after a crash/failure at any step. Before CUTOVER
        committed, src is still authoritative: the partial dst state is
        discarded bit-exactly and the migration re-runs from a fresh
        FORK. From CUTOVER on, the migration rolls forward (the
        remaining steps are idempotent)."""
        with self._lock:
            state = self._record["state"]
            done = list(self._record["steps_done"])
        if state == "done":
            return self.record()
        if state == "rolled_back":
            # an explicit abort is final: the tenant is serving on src
            # and must not be silently re-throttled and re-migrated by
            # a retry loop — start a NEW migration instead
            raise MigrationError(
                f"migration {self.migration_id} was rolled back; "
                f"start a new migration to retry")
        self.stats.add(resumed=1)
        with self._lock:
            self._record["resumed"] += 1
        if "cutover" not in done:
            self._undo_partial()
            self._commit(state="running", steps_done=[])
        return self._run_steps()

    def rollback(self) -> dict:
        """Abort back to src (only legal before CUTOVER commits —
        afterwards the make-before-break contract says roll forward).
        The tenant's stream continues on src byte-identical to a plane
        that never attempted the migration."""
        with self._lock:
            if "cutover" in self._record["steps_done"]:
                raise MigrationError(
                    "cutover already committed; resume() rolls forward")
        self._undo_partial()
        self.src.registry.release_hold(self.tenant)
        with self._lock:
            self._record["rollbacks"] += 1
        self._commit(state="rolled_back", steps_done=[],
                     finished_s=time.time())
        self.stats.add(rolled_back=1)
        self.log.info("migration rolled back %s", _fields(
            id=self.migration_id, tenant=self.tenant))
        return self.record()

    def _undo_partial(self) -> None:
        """Discard everything a pre-cutover crash may have left on dst
        (and return any transferred frames to src, in order). Safe to
        run however little actually happened: every sub-step checks
        before acting. The src hold stays — migrate() re-applies it
        anyway and rollback() releases it explicitly."""
        with self._lock:
            fork = self._record.get("fork")
        src_d = self.src.daemon
        if fork is None:
            return
        pairs = self._wire_pairs(fork, require_dst=False)
        # 1. redirects off first: arrivals stay on src from here on
        for ws, _wd in pairs:
            if ws is not None:
                src_d.wires._install_notify(ws)
        # 2. transferred frames back to the FRONT of src queues, FIFO
        for ws, wd in pairs:
            if ws is None or wd is None:
                continue
            moved = []
            while True:
                try:
                    moved.append(wd.ingress.popleft())
                except IndexError:
                    break
            if moved:
                ws.ingress.extendleft(reversed(moved))
        # 3. dst partial state: rows, wires, store records, tenant —
        # the shared dst half of the crash contract
        discard_partial_restore(self.dst, self.tenant, fork)

    # -- steps ---------------------------------------------------------

    def _step_throttle(self) -> None:
        reg = self.src.registry
        t = reg.get(self.tenant)
        if t is None:
            raise MigrationError(
                f"unknown tenant {self.tenant!r} on {self.src.name}")
        reg.hold(self.tenant)
        self._chaos_step("throttle")
        self._commit("throttle", throttle={
            "qos": t.qos,
            "frame_budget_per_s": t.frame_budget_per_s,
            "byte_budget_per_s": t.byte_budget_per_s,
        })

    def _step_fork(self) -> None:
        src = self.src
        reg = src.registry
        engine = src.engine

        def _capture():
            t = reg.get(self.tenant)
            spaces = sorted(t.namespaces)
            rows = reg.rows_of(self.tenant)
            with engine._lock:
                engine._flush_device_locked()
                st = engine._state
                # one gather per column over the tenant's rows, copied
                # to the host: the fork barrier stays O(tenant rows)
                ri = torch.as_tensor(rows, dtype=torch.int64,
                                     device=st.device)

                def take(col):
                    return col.index_select(0, ri).cpu().numpy()

                # incrementally-maintained inverse of _pod_ids: the
                # fork barrier must be O(tenant rows), and rebuilding
                # the whole inverse map here was an O(all pods) walk
                # inside the tick-lock barrier (dtnscale scost)
                id_to_name = engine._pod_names
                src_col = take(st.src)
                dst_col = take(st.dst)
                identities = []
                keyset = set()
                for i, r in enumerate(rows.tolist()):
                    pod_key, uid = engine._row_owner[r]
                    keyset.add((pod_key, uid))
                    identities.append([
                        pod_key, int(uid),
                        id_to_name.get(int(src_col[i]), pod_key),
                        id_to_name.get(int(dst_col[i]), pod_key),
                        bool(r in engine._shaped_rows)])
                # walk the TENANT's keys, not the whole peer registry
                # (sorted for a deterministic fork record)
                peers = []
                for k in sorted(keyset):
                    p = engine._peer.get(k)
                    if p is not None and p in keyset:
                        peers.append([k[0], k[1], p[0], p[1]])
                arrays = {
                    "rows": rows.astype(np.int64),
                    "props": take(st.props),
                    "tokens": take(st.tokens),
                    "t_last": take(st.t_last),
                    "corr": take(st.corr),
                    "pkt_count": take(st.pkt_count),
                    "backlog_until": take(st.backlog_until),
                }
            topologies = []
            for ns in spaces:
                for topo in src.store.list(ns):
                    topologies.append({
                        "manifest": topo.to_manifest(),
                        "finalizers": list(topo.finalizers),
                    })
            wires = [[w.pod_key, int(w.uid), w.peer_ip,
                      int(w.peer_intf_id), w.node_iface_name]
                     for w in src.daemon.wires.in_namespaces(spaces)]
            fork = {
                "identities": identities,
                "peers": peers,
                "topologies": topologies,
                "wires": wires,
                "registry": {
                    "qos": t.qos,
                    "frame_budget_per_s": t.frame_budget_per_s,
                    "byte_budget_per_s": t.byte_budget_per_s,
                    "block_rows": int(t.block_rows),
                    "namespaces": spaces,
                },
                "fork_shaped_s": src.plane._last_shaped_s,
                "counters_at_fork": reg.tenant_counters(src.plane,
                                                        self.tenant),
            }
            return fork, arrays

        fork, arrays = src.plane.stage_update_round(
            _capture, cause="migration_fork",
            migration=self.migration_id, tenant=self.tenant,
            rows=int(reg.rows_of(self.tenant).size))
        self._fork_arrays = arrays
        self._chaos_step("fork")
        self._commit("fork", arrays=arrays, fork=fork)

    def _step_restore(self) -> None:
        dst = self.dst
        with self._lock:
            fork = self._record["fork"]
        arrays = self._fork_arrays
        if arrays is None:
            _rec, arrays = journal.load_record(self.journal_root,
                                               self.migration_id)
            self._fork_arrays = arrays

        def _apply():
            return len(restore_tenant_slice(
                dst, self.tenant, fork, arrays, self.src.addr,
                hold=True))

        n_rows = dst.plane.stage_update_round(
            _apply, cause="migration_restore",
            migration=self.migration_id, tenant=self.tenant,
            rows=int(len(arrays["rows"])))
        self._chaos_step("restore")
        self._commit("restore", restored_rows=int(n_rows))

    def _wire_pairs(self, fork: dict, require_dst: bool = True):
        pairs = []
        for pod_key, uid, _peer_ip, _pid, _if in fork["wires"]:
            ws = self.src.daemon.wires.get_by_key(pod_key, int(uid))
            wd = self.dst.daemon.wires.get_by_key(pod_key, int(uid))
            if require_dst and (ws is None or wd is None):
                continue
            pairs.append((ws, wd))
        return pairs

    @staticmethod
    def _transfer(ws, wd) -> int:
        """Move every queued ingress entry src→dst wire, FIFO, counting
        frames (a bulk FrameSeg entry counts its window)."""
        from kubedtn_tpu_torch.wire.server import _entry_frames

        moved = 0
        while True:
            try:
                e = ws.ingress.popleft()
            except IndexError:
                return moved
            wd.ingress.append(e)
            moved += _entry_frames(e)

    def _step_cutover(self) -> None:
        with self._lock:
            fork = self._record["fork"]
        dst_d = self.dst.daemon

        def _cut():
            pairs = self._wire_pairs(fork)
            moved = 0
            for ws, wd in pairs:
                moved += self._transfer(ws, wd)
            # make-before-break: dst is fully able to serve (RESTORE
            # committed) before the redirect breaks the src path. A
            # producer still holding the src wire forwards through the
            # redirect from its very next append.
            for ws, wd in pairs:
                ing = ws.ingress
                if hasattr(ing, "_notify"):
                    def redirect(_ws=ws, _wd=wd):
                        self._transfer(_ws, _wd)

                    ing._notify = redirect
            # close the race: entries landed between the sweep and the
            # redirect install sit unnotified on src — one more sweep
            for ws, wd in pairs:
                moved += self._transfer(ws, wd)
            return moved

        moved = self.src.plane.stage_update_round(
            _cut, cause="migration_cutover",
            migration=self.migration_id, tenant=self.tenant)
        self._chaos_step("cutover")
        prev = 0
        with self._lock:
            prev = self._record.get("cutover", {}).get(
                "transferred_frames", 0)
        self._commit("cutover",
                     cutover={"transferred_frames": int(moved) + prev})

    # -- reconcile helpers --------------------------------------------

    def _src_residue(self, spaces: set[str], wire_ids: set[int],
                     peer_addrs: set[str]) -> dict:
        """Tenant frames still owed by src: queued ingress (swept to
        dst as a side effect), holdback entries, frames of dispatches in
        flight, delay-line frames (the `_pending` batches; the port
        releases only through the native timing wheel, so there is no
        heap to count), peer egress buffers.

        The in-flight count is the port's repair of a JAX fault: a held
        tenant's holdback residue still shapes on src, and at pipeline
        depth 2 a tick leaves its last chunk in flight — out of the
        holdback, not yet in the delay line. The JAX package's check
        passes then and freezes the src counters without those frames,
        which complete after the freeze and are lost with the src wires
        at RELEASE (tests/test_torch_federation.py pins both)."""
        src = self.src
        plane = src.plane
        swept = 0
        with self._lock:
            fork = self._record["fork"]
        for ws, wd in self._wire_pairs(fork):
            swept += self._transfer(ws, wd)
        hold = pend = infl = 0
        with plane._tick_lock:
            for wid in plane._holdback:
                if wid in wire_ids:
                    hold += 1
            for job in plane._inflight:
                for wire, _row, lens, _fr, _pd in job.batches:
                    if wire.wire_id in wire_ids:
                        infl += len(lens)
            for entry in plane._pending.values():
                if entry[0].partition("/")[0] in spaces:
                    pend += int(entry[4])
        peer_buffered = 0
        breaker_open = False
        for addr in peer_addrs:
            sender = plane._peer_senders.get(addr)
            if sender is None:
                continue
            peer_buffered += sender.buffered
            if sender.breaker.state != fault.CLOSED:
                breaker_open = True
        return {"swept": swept, "holdback": hold, "inflight": infl,
                "pending": pend, "peer_buffered": peer_buffered,
                "breaker_open": breaker_open}

    def _step_reconcile(self) -> None:
        src, dst = self.src, self.dst
        with self._lock:
            fork = self._record["fork"]
        spaces = set(fork["registry"]["namespaces"])
        wire_ids = {ws.wire_id for ws, _ in
                    self._wire_pairs(fork, require_dst=False)
                    if ws is not None}
        peer_addrs = {w[2] for w in fork["wires"] if w[2]}
        # cutover committed: dst may serve — release its hold first so
        # the transferred backlog starts draining while src residuals
        # finish
        dst.registry.release_hold(self.tenant)
        deadline = time.monotonic() + self.reconcile_timeout_s
        while True:
            res = self._src_residue(spaces, wire_ids, peer_addrs)
            if (res["holdback"] == 0 and res["inflight"] == 0
                    and res["pending"] == 0 and res["peer_buffered"] == 0):
                break
            now = time.monotonic()
            if now >= deadline:
                if res["breaker_open"]:
                    # breaker-aware: an OPEN src→peer breaker means the
                    # outage buffer is still legitimately parked —
                    # extend to the next half-open probe instead of
                    # failing a migration the fault layer will finish
                    probe = max((src.plane._peer_senders[a].breaker
                                 .time_to_probe()
                                 for a in peer_addrs
                                 if a in src.plane._peer_senders),
                                default=0.0)
                    deadline = now + max(probe, 0.05) + 1.0
                else:
                    raise MigrationError(
                        f"reconcile: src residuals did not drain: {res}")
            if self.settle is not None:
                self.settle()
            else:
                time.sleep(0.01)
        counters_src = src.registry.tenant_counters(src.plane,
                                                    self.tenant)
        counters_dst = dst.registry.tenant_counters(dst.plane,
                                                    self.tenant)
        win_src = src.registry.tenant_window(src.plane, self.tenant)
        win_dst = dst.registry.tenant_window(dst.plane, self.tenant)
        self._chaos_step("reconcile")
        self.stats.add(bytes_reconciled=(
            counters_src["delivered_bytes"]
            + counters_dst["delivered_bytes"]))
        self._commit("reconcile", reconcile={
            # the src slice is FROZEN here — RELEASE frees the rows and
            # deregisters the tenant, after which the slice is gone
            "counters_src": counters_src,
            "counters_dst_at_reconcile": counters_dst,
            "delivered_src_frames": counters_src["delivered_packets"],
            "delivered_src_bytes": counters_src["delivered_bytes"],
            "window_src": win_src,
            "window_dst": win_dst,
            "peer_fault_stats": src.plane.peer_fault_stats(),
        })

    def _drop_store_record(self, handle: PlaneHandle, ns: str,
                           name: str) -> None:
        from kubedtn_tpu_torch.topology.store import NotFoundError

        try:
            handle.store.get(ns, name)
        except NotFoundError:
            return
        try:
            # clears placement + our finalizer so delete() completes
            handle.engine.set_alive(name, ns, "", "")
            handle.store.delete(ns, name)
        except NotFoundError:
            pass

    def _step_release(self) -> None:
        src = self.src
        with self._lock:
            fork = self._record["fork"]
        keys = [(pk, int(uid)) for pk, uid, *_rest in fork["identities"]]
        spaces = set(fork["registry"]["namespaces"])

        def _free():
            return src.engine.abandon_rows(keys)

        freed = src.plane.stage_update_round(_free)
        # delivered-but-unconsumed EGRESS frames ride to dst before the
        # wires go: egress is the consumer's delivery buffer, and the
        # consumer re-attaches to the dst wire — deleting a src wire
        # must never delete deliveries the consumer has not picked up
        # yet (found by the fleet_rolling_upgrade zero-loss drive: a
        # consumer that polls slower than the migration completes lost
        # every frame delivered during the move). Idempotent: a resumed
        # RELEASE finds the already-moved egress empty.
        handed_off = 0
        for ws in src.daemon.wires.in_namespaces(spaces):
            wd = self.dst.daemon.wires.get_by_key(ws.pod_key, ws.uid)
            if wd is None:
                continue
            moved = []
            while True:
                try:
                    moved.append(ws.egress.popleft())
                except IndexError:
                    break
            if moved:
                # PREPEND, order preserved: src delivered these before
                # dst's post-cutover deliveries, and a consumer slower
                # than the migration must still read the wire FIFO
                # (same discipline as the rollback path's
                # ingress.extendleft)
                wd.egress.extendleft(reversed(moved))
                handed_off += len(moved)
        pod_keys = {w.pod_key
                    for w in src.daemon.wires.in_namespaces(spaces)}
        for pk in pod_keys:
            src.daemon.wires.delete_by_pod(pk)
        for rec in fork["topologies"]:
            meta = rec["manifest"]["metadata"]
            self._drop_store_record(src, meta.get("namespace",
                                                  "default"),
                                    meta["name"])
        src.registry.release_hold(self.tenant)
        src.registry.delete(self.tenant)
        self._chaos_step("release")
        self._commit("release", released_rows=int(freed),
                     egress_handed_off=int(handed_off))

    # -- accounting ----------------------------------------------------

    @staticmethod
    def _accounted(counters: dict) -> float:
        """Frames with a TERMINAL outcome in one plane's counter
        slice: delivered, or dropped with a recorded cause (netem
        loss / TBF queue / egress ring). Every fed frame must reach
        exactly one terminal outcome on exactly one plane."""
        return (counters.get("delivered_packets", 0.0)
                + counters.get("dropped_loss", 0.0)
                + counters.get("dropped_queue", 0.0)
                + counters.get("dropped_ring", 0.0))

    def check_accounting(self, fed_frames: int) -> dict:
        """The byte-exact reconciliation rule: every fed frame reached
        a terminal outcome (delivered, or dropped with cause) on
        exactly one plane — `fed == accounted_src + accounted_dst`
        (which on lossless links is exactly fed == delivered_src +
        delivered_dst). The src slice is frozen at RECONCILE (gone
        after RELEASE); dst is read live. Updates the
        kubedtn_migration_accounting_mismatch gauge."""
        with self._lock:
            rec = self._record.get("reconcile")
        if rec is None:
            raise MigrationError("reconcile has not run")
        a_src = self._accounted(rec["counters_src"])
        d_src = float(rec["delivered_src_frames"])
        t = self.dst.registry.get(self.tenant)
        counters_dst = (self.dst.registry.tenant_counters(
            self.dst.plane, self.tenant) if t is not None
            else rec["counters_dst_at_reconcile"])
        a_dst = self._accounted(counters_dst)
        d_dst = float(counters_dst.get("delivered_packets", 0.0))
        mismatch = float(fed_frames) - (a_src + a_dst)
        self.stats.set_mismatch(abs(mismatch))
        out = {"fed": int(fed_frames),
               "accounted_src": a_src, "accounted_dst": a_dst,
               "delivered_src": d_src, "delivered_dst": d_dst,
               "mismatch": mismatch}
        with self._lock:
            self._record["accounting"] = out
        return out


@guarded_by("_lock", "_handles", "_coords", "_seq", "_active")
class FederationController:
    """The placement layer's migration surface for one process's
    member planes: register PlaneHandles, run/resume migrations, and
    answer `Local.MigrateTenant` / `Local.MigrationStatus` for every
    registered daemon. Extensible to N planes — a migration only ever
    involves the (src, dst) pair it names."""

    def __init__(self, journal_root: str,
                 stats: MigrationStats | None = None,
                 chaos=None) -> None:
        self.journal_root = journal_root
        self.stats = stats if stats is not None else MigrationStats()
        self.chaos = chaos
        # set by the fleet supervisor (federation.supervisor.attach):
        # called with (tenant, dst_plane, qos) after every COMPLETED
        # migration so the placement ledger tracks manual `kdt migrate`
        # moves too, not only supervisor-driven ones
        self.placement_hook = None
        self._lock = threading.Lock()
        self._handles: dict[str, PlaneHandle] = {}
        self._coords: dict[str, MigrationCoordinator] = {}
        # tenants with a migrate()/resume() currently RUNNING: the
        # state machine is single-writer per tenant — a concurrent
        # second RPC refuses loudly instead of interleaving barriers
        self._active: set[str] = set()
        self._seq = 0

    def register(self, handle: PlaneHandle) -> PlaneHandle:
        with self._lock:
            self._handles[handle.name] = handle
        handle.daemon.federation = self
        return handle

    def handle(self, name: str) -> PlaneHandle:
        with self._lock:
            h = self._handles.get(name)
        if h is None:
            raise MigrationError(f"unknown federation plane {name!r}")
        return h

    def plane_names(self) -> list[str]:
        with self._lock:
            return sorted(self._handles)

    def _notify_placement(self, tenant: str, dst: str) -> None:
        hook = self.placement_hook
        if hook is None:
            return
        try:
            t = self.handle(dst).registry.get(tenant)
            hook(tenant, dst, t.qos if t is not None else None)
        except Exception:
            # the move itself succeeded; a lagging ledger is the
            # supervisor's to reconcile on its next attach/sweep
            get_logger("federation").exception(
                "placement hook failed (ledger may lag) %s",
                _fields(tenant=tenant, dst=dst))

    def plane_name_of(self, daemon) -> str:
        """The registered plane name serving `daemon` (the RPC surface
        defaults a MigrateRequest's empty src to the serving plane)."""
        with self._lock:
            for name, h in self._handles.items():
                if h.daemon is daemon:
                    return name
        raise MigrationError("daemon is not a registered plane")

    def _begin(self, tenant: str) -> None:
        with self._lock:
            if tenant in self._active:
                raise MigrationError(
                    f"a migration of tenant {tenant!r} is already "
                    f"running")
            self._active.add(tenant)

    def _end(self, tenant: str) -> None:
        with self._lock:
            self._active.discard(tenant)

    def _new_migration_id(self, tenant: str,
                          requested: str | None) -> str:
        """Allocate an id that names NO existing journal record: the
        in-memory sequence resets on restart, and silently reusing an
        id would rename a committed record's history away (and attach
        its carried-forward fork.npz to the new migration)."""
        with self._lock:
            if requested:
                if os.path.isdir(journal.record_dir(self.journal_root,
                                                    requested)):
                    raise MigrationError(
                        f"migration id {requested!r} already has a "
                        f"journal record; resume it or pick a new id")
                return requested
            while True:
                self._seq += 1
                mid = f"{tenant}-{self._seq:04d}"
                if not os.path.isdir(journal.record_dir(
                        self.journal_root, mid)):
                    return mid

    def migrate(self, tenant: str, src: str, dst: str,
                migration_id: str | None = None, settle=None,
                reconcile_timeout_s: float = 30.0) -> dict:
        if src == dst:
            raise MigrationError("src and dst are the same plane")
        hs, hd = self.handle(src), self.handle(dst)
        mid = self._new_migration_id(tenant, migration_id)
        co = MigrationCoordinator(
            tenant, hs, hd, self.journal_root, mid, stats=self.stats,
            chaos=self.chaos, settle=settle,
            reconcile_timeout_s=reconcile_timeout_s)
        with self._lock:
            self._coords[mid] = co
        self._begin(tenant)
        try:
            rec = co.migrate()
        finally:
            self._end(tenant)
        if rec.get("state") == "done":
            self._notify_placement(tenant, dst)
        return rec

    def coordinator(self, migration_id: str) -> MigrationCoordinator:
        with self._lock:
            co = self._coords.get(migration_id)
            handles = dict(self._handles)
        if co is None:
            co = MigrationCoordinator.from_journal(
                self.journal_root, migration_id, handles,
                stats=self.stats, chaos=self.chaos)
            with self._lock:
                # two racing rebuilds: first publish wins, both callers
                # get the SAME coordinator (never two state machines
                # over one journal record)
                co = self._coords.setdefault(migration_id, co)
        return co

    def resume(self, migration_id: str) -> dict:
        co = self.coordinator(migration_id)
        self._begin(co.tenant)
        try:
            rec = co.resume()
        finally:
            self._end(co.tenant)
        if rec.get("state") == "done":
            self._notify_placement(co.tenant, co.dst.name)
        return rec

    # how long a completed migration's frozen src window slice keeps
    # stitching into the fleet SLO view. The slice exists to make the
    # view CONTINUOUS across the move; burn rates and budgets are
    # WINDOWED, so a fixed pre-move slice must age out once the dst's
    # own ring covers the alerting windows — without a bound, a loss
    # in the pre-move window would depress the tenant's fleet budget
    # forever while every live plane reads clean. The default is
    # sized an order of magnitude above the default slow alerting
    # window (12 × 1s telemetry windows): wide enough that the view
    # is continuous while the dst ring fills, narrow enough that a
    # stale pre-move loss ages out promptly.
    FROZEN_WINDOW_MAX_AGE_S = 120.0

    def frozen_windows(self, tenant: str = "", src: str = "",
                       max_age_s: float | None = None) -> list[tuple]:
        """The SLO plane's migration stitch input: every RECENTLY
        completed record's RECONCILE-frozen src window slice, as
        (src_plane, tenant, window_src, qos) tuples (slo.fleet merges
        them with the live planes' verdicts so a migrated tenant's
        fleet view is continuous across the move). One pass over the
        journal metas; records predating the window `hist` field are
        skipped — the merge cannot stitch what was never frozen — and
        records older than `max_age_s` (default
        FROZEN_WINDOW_MAX_AGE_S) have aged out of the windowed view."""
        horizon = (self.FROZEN_WINDOW_MAX_AGE_S
                   if max_age_s is None else float(max_age_s))
        now = time.time()
        out = []
        for rec in self.status(tenant=tenant):
            if rec.get("state") != "done":
                continue
            if src and rec.get("src") != src:
                continue
            done_s = rec.get("finished_s")
            if done_s is not None and now - float(done_s) > horizon:
                continue
            win = (rec.get("reconcile") or {}).get("window_src")
            if not win or not win.get("hist"):
                continue
            qos = ((rec.get("fork") or {}).get("registry")
                   or {}).get("qos")
            out.append((rec.get("src", ""), rec.get("tenant", ""),
                        win, qos))
        return out

    def status(self, migration_id: str = "",
               tenant: str = "") -> list[dict]:
        with self._lock:
            coords = dict(self._coords)
        known = {mid: co.record() for mid, co in coords.items()}
        for mid in journal.list_records(self.journal_root):
            if mid not in known:
                try:
                    known[mid] = journal.load_record_meta(
                        self.journal_root, mid)
                except journal.JournalError:
                    continue
        out = [r for mid, r in sorted(known.items())
               if (not migration_id or mid == migration_id)
               and (not tenant or r.get("tenant") == tenant)]
        return out
