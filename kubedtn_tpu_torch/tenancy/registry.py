"""TenantRegistry — tenants, edge blocks, QoS, and per-tenant slicing.

Port of kubedtn_tpu/tenancy/registry.py. Host code over the port's
engine: the allocation hooks, the columnar ownership masks and the
admission policy are the JAX package's line for line. The per-tenant
counter slice reads the plane's cumulative counters, which the port
keeps on the HOST as float32 numpy columns (runtime._zero_counters):
one fancy-index gather per column and a numpy float32 sum, the JAX
package's expression, so the sums are equal bit for bit. The
tenant-scoped fork masks the snapshot's `active` column on its device.
`hold` / `release_hold` have no caller in the port until the
federation is ported.

The registry is the single source of truth for tenant identity:

- **namespace → tenant**: every pod key's namespace maps to at most
  one tenant (default: a tenant named after the namespace, auto-bound
  by the reconciler's `ensure_namespace` hook). Untenanted namespaces
  keep the historical shared-pool behavior everywhere.
- **edge blocks**: a tenant may reserve a contiguous row range in the
  shared SoA (`parallel.partition.tenant_block` — composes with shard
  blocks). The engine's allocator consults `alloc_row`/`alloc_pair`
  first, so the tenant's links pack into its block; freed block rows
  return to the tenant's pool, never to another tenant.
- **accounting row sets**: per-tenant counter/telemetry slices come
  from COLUMNAR OWNERSHIP MASKS (one capacity-sized bool column per
  tenant plus a row→tenant int column), maintained incrementally at
  every row bind/unbind (`note_bind`/`note_unbind`, O(1) per row) and
  permuted through `compact()`'s renumbering with the same vectorized
  gather the SoA columns use — exact through the repack, whether or
  not blocks are reserved. The historical accounting re-derived each
  tenant's row set from the engine registries per registry
  generation: an O(all-rows) Python walk after EVERY alloc/free,
  which the dtnscale layer now budgets out. A namespace-binding
  change (tenant create/delete, bind_namespace) is the one slow
  path: it marks the masks stale and the next `rows_of` rebuilds
  them in one pass. Blocks are an allocation and isolation-audit
  structure, not the accounting source of truth; a global compact
  dissolves them (rows were renumbered) and the registry immediately
  re-carves each tenant's reservation at its full requested size from
  the repacked free list (`on_compact`); when a re-carve no longer
  fits, the tenant heals on the next compact or
  `create(block_edges=...)`.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from kubedtn_tpu_torch.tenancy.admission import (AdmissionController,
                                           HostTokenBucket,
                                           ThrottleVerdict)
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

# QoS class → drain-budget weight (share of the plane's per-wire drain
# budget a tenant's wires get under contention) and stable level code
# for metrics (0 = gold).
QOS_CLASSES: dict[str, float] = {"gold": 1.0, "silver": 0.5,
                                 "bronze": 0.25}
QOS_LEVELS: dict[str, int] = {"gold": 0, "silver": 1, "bronze": 2}


@dataclasses.dataclass
class Tenant:
    """One tenant's identity, quotas, and cumulative meters."""

    name: str
    qos: str = "gold"
    frame_budget_per_s: float = 0.0   # 0 = unlimited
    byte_budget_per_s: float = 0.0    # 0 = unlimited
    namespaces: set = dataclasses.field(default_factory=set)
    block: tuple[int, int] | None = None   # reserved [lo, hi) or None
    block_free: list = dataclasses.field(default_factory=list)
    # rows the tenant's reservation was REQUESTED with (block_edges):
    # survives compact()'s dissolve so the re-carve restores the full
    # entitlement, not whatever happened to be unused at repack time
    block_rows: int = 0
    bucket_frames: HostTokenBucket = None
    bucket_bytes: HostTokenBucket = None
    admitted_frames: int = 0
    admitted_bytes: int = 0
    created_at: float = dataclasses.field(default_factory=time.time)

    def __post_init__(self) -> None:
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"unknown QoS class {self.qos!r}; "
                             f"choices: {', '.join(QOS_CLASSES)}")
        if self.bucket_frames is None:
            self.bucket_frames = HostTokenBucket(self.frame_budget_per_s)
        if self.bucket_bytes is None:
            self.bucket_bytes = HostTokenBucket(self.byte_budget_per_s)

    @property
    def weight(self) -> float:
        return QOS_CLASSES[self.qos]


class TenantRegistry:
    """Tenant control plane over one engine (and, once attached via
    `WireDataPlane.attach_tenancy`, one live plane)."""

    # default_qos MUST be the weight-1.0 class: cmd_daemon attaches a
    # registry unconditionally and the reconciler auto-registers a
    # tenant per namespace, so any other default would silently scale
    # every wire's drain budget on a plane nobody configured tenancy on
    # ("empty registry = zero enforcement" is a documented contract)
    def __init__(self, engine, default_qos: str = "gold") -> None:
        self.engine = engine
        self.default_qos = default_qos
        self.plane = None                  # set by attach_tenancy
        self.admission = AdmissionController()
        self.log = get_logger("tenancy")
        self._lock = threading.RLock()
        self._tenants: dict[str, Tenant] = {}
        self._ns_map: dict[str, str] = {}  # namespace -> tenant name
        # tenants under a migration hold: drain budget 0 this tick,
        # frames queue (never dropped) — the THROTTLE clamp of the
        # federation migration state machine (process state, not
        # persisted: a restarted daemon resumes the migration from its
        # journal, which re-applies the hold)
        self._holds: set[str] = set()
        # -- columnar per-tenant accounting (see module docstring) ----
        # row → tenant id (-1 = untenanted) and one bool ownership
        # mask per tenant, maintained incrementally by note_bind/
        # note_unbind and permuted vectorized through compact
        cap = int(engine._state.capacity)
        self._cap = cap
        self._row_tenant: np.ndarray = np.full((cap,), -1, np.int32)
        # row → id of the tenant whose RESERVED BLOCK contains it
        # (-1 = global pool): release_row resolves a freed row's pool
        # in O(1) instead of scanning every tenant's block bounds
        # per row (freeing N rows was O(N·tenants))
        self._block_owner: np.ndarray = np.full((cap,), -1, np.int32)
        self._masks: dict[str, np.ndarray] = {}
        self._tenant_ids: dict[str, int] = {}   # name → stable int id
        self._tenant_names: list[str] = []      # id → name
        # namespace bindings changed since the masks were built: the
        # next rows_of rebuilds them in ONE pass (the rare control-
        # plane path; the steady alloc/free path stays incremental)
        self._masks_stale: bool = True
        # unused rows currently held inside tenant blocks, maintained
        # as ONE counter at carve/alloc/release/dissolve time — the
        # engine's _ensure_capacity reads it on barrier paths, where
        # a per-call walk of every tenant's pool was a redundant
        # accounting re-derive (dtnscale scost)
        self._reserved_free_n: int = 0
        engine.tenancy = self

    # -- lifecycle -----------------------------------------------------

    def create(self, name: str, qos: str | None = None,
               frame_budget_per_s: float | None = None,
               byte_budget_per_s: float | None = None,
               block_edges: int = 0,
               namespaces=None) -> Tenant:
        """Register a tenant; with `block_edges` > 0, reserve that many
        contiguous SoA rows for it now (growing capacity first if the
        free list cannot hold a run). Idempotent on name: re-creating
        binds any NEW namespaces and updates only the quotas actually
        PROVIDED — `None` budgets/qos leave the existing values alone
        (so the reconciler's `ensure_namespace` path can never wipe an
        operator-set budget back to unlimited) — and never moves an
        EXISTING block, but does reserve one when `block_edges` > 0
        and the tenant has none (the lazy half of post-compact block
        recovery — see `on_compact`). On a NEW tenant, `None` budgets
        mean unlimited.

        Lock order is ENGINE lock before registry lock everywhere (the
        allocator hooks run under the engine lock and read the
        registry), so block reservation — which needs the engine lock
        — always happens OUTSIDE the registry lock."""
        with self._lock:
            existing = self._tenants.get(name)
            if existing is not None:
                for ns in (set(namespaces) if namespaces else {name}):
                    newly = ns not in self._ns_map
                    # never steal a namespace already mapped elsewhere
                    if self._ns_map.setdefault(ns, name) == name:
                        existing.namespaces.add(ns)
                        if newly:
                            # a new binding may adopt already-realized
                            # rows: rebuild the masks on next query
                            self._masks_stale = True
                out = self.set_quota(name, qos=qos,
                                     frame_budget_per_s=
                                     frame_budget_per_s,
                                     byte_budget_per_s=byte_budget_per_s)
                need_block = block_edges > 0 and existing.block is None
                size_kept = (block_edges > 0
                             and existing.block is not None
                             and existing.block_rows != block_edges)
        if existing is not None:
            if need_block:
                self._reserve_block(existing, int(block_edges))
                self.log.info("tenant block reserved %s", _fields(
                    tenant=name,
                    block=list(existing.block) if existing.block
                    else None))
            elif size_kept:
                # blocks never move or resize once reserved — say so
                # instead of silently ignoring the differing request
                self.log.info("tenant block size kept %s", _fields(
                    tenant=name, requested=int(block_edges),
                    reserved=existing.block_rows))
            return out
        t = Tenant(name=name, qos=qos or self.default_qos,
                   frame_budget_per_s=frame_budget_per_s or 0.0,
                   byte_budget_per_s=byte_budget_per_s or 0.0,
                   namespaces=set(namespaces)
                   if namespaces else {name})
        # publish BEFORE reserving: a block carved for an unpublished
        # tenant would be invisible to a concurrent compact() —
        # on_compact walks only published tenants, so the rebuilt
        # global free list would recycle the carved rows while the
        # tenant still held them (the same SoA rows allocatable from
        # two pools). Published first, the tenant is dissolved and
        # re-carved by on_compact like any other. When two creates
        # race, the FIRST reservation to land wins (the loser may even
        # carve it on the winner's behalf below); a racing different
        # block_edges is ignored like any re-create's — blocks never
        # move or resize once reserved.
        with self._lock:
            won = self._tenants.setdefault(name, t)
            if won.name not in self._tenant_ids:
                # stable accounting id (never reused — a deleted
                # tenant's residual _row_tenant entries must not alias
                # a later tenant's mask)
                self._tenant_ids[won.name] = len(self._tenant_names)
                self._tenant_names.append(won.name)
            for ns in t.namespaces:
                # bind this call's namespaces to whoever WON the
                # publish race: admission (ns_map) and accounting
                # (won.namespaces) must agree on every namespace
                if self._ns_map.setdefault(ns, won.name) == won.name:
                    won.namespaces.add(ns)
            self._masks_stale = True
            need_block = block_edges > 0 and won.block is None
        if need_block:
            # a reservation failure (ValueError) leaves the tenant
            # registered without a block; the next
            # create(block_edges=...) retries via the lazy path
            self._reserve_block(won, int(block_edges))
        self.log.info("tenant created %s", _fields(
            tenant=name, qos=won.qos,
            frame_budget=frame_budget_per_s,
            byte_budget=byte_budget_per_s,
            block=list(won.block) if won.block else None))
        return won

    @staticmethod
    def _block_free_of(blk: tuple[int, int]) -> list[int]:
        # descending free list: consecutive pops hand out consecutive
        # rows, so link pairs colocate exactly like the global pool's
        return list(range(blk[1] - 1, blk[0] - 1, -1))

    def _reserve_block(self, t: Tenant, n_rows: int) -> None:
        """Reserve a contiguous block for `t`, repacking once if the
        free list is too fragmented to hold a run. First reservation
        wins: if a concurrent reserver (or the repack's own on_compact
        re-carve, which uses the tenant's REMEMBERED block_rows)
        established a block of a different size meanwhile, that block
        is kept — blocks never move or resize — and the mismatch is
        logged rather than silently absorbed."""
        if not self._carve_and_publish(t, n_rows):
            # fragmented free list: one repack restores contiguity
            # (compact dissolves every existing block — the rows were
            # renumbered — and on_compact eagerly re-carves the OTHER
            # tenants' reservations; ours comes from what remains.
            # Accounting is row-set based and unaffected)
            self.engine.compact()
            if not self._carve_and_publish(t, n_rows):
                raise ValueError(
                    f"cannot reserve {n_rows} contiguous rows for "
                    f"tenant {t.name} (capacity "
                    f"{self.engine._state.capacity})")
        with self._lock:
            reserved = t.block_rows
        if reserved != n_rows:
            self.log.info("tenant block size kept %s", _fields(
                tenant=t.name, requested=int(n_rows),
                reserved=reserved))

    def _carve_and_publish(self, t: Tenant, n_rows: int) -> bool:
        """Carve a contiguous run off the engine free list and publish
        it as `t.block` in ONE engine-lock hold: a compact() cannot
        interleave and recycle the carved-but-unpublished rows into
        its rebuilt global free list, and a published tenant's
        allocator hooks (which run under the engine lock) never see a
        half-built reservation. `t` must already be in `_tenants`
        (create publishes the tenant BEFORE reserving) — a block on an
        unregistered tenant would be invisible to on_compact. True
        when `t` has a block on return — ours, or a racing reserver's
        (first publish wins)."""
        from kubedtn_tpu_torch.parallel.partition import tenant_block

        engine = self.engine
        with engine._lock:
            with self._lock:
                if t.block is not None:
                    return True
            engine._ensure_capacity(n_rows)
            blk = tenant_block(engine._free, engine._state.capacity,
                               getattr(engine, "shard_count", 1),
                               n_rows)
            if blk is None:
                return False
            with self._lock:
                t.block = blk
                t.block_rows = n_rows
                t.block_free = self._block_free_of(blk)
                self._reserved_free_n += len(t.block_free)
                self._set_block_owner_locked(t, blk)
        return True

    def _set_block_owner_locked(self, t: Tenant,
                                blk: tuple[int, int]) -> None:
        """Vectorized range-write of the block-owner column (caller
        holds the registry lock; the tenant must be published so it
        has a stable id)."""
        tid = self._tenant_ids.get(t.name)
        if tid is None:
            return
        if blk[1] > self._block_owner.shape[0]:
            grown = np.full((blk[1],), -1, np.int32)
            grown[:self._block_owner.shape[0]] = self._block_owner
            self._block_owner = grown
        self._block_owner[blk[0]:blk[1]] = tid

    def set_quota(self, name: str, qos: str | None = None,
                  frame_budget_per_s: float | None = None,
                  byte_budget_per_s: float | None = None) -> Tenant:
        with self._lock:
            t = self._tenants[name]
            if qos:
                if qos not in QOS_CLASSES:
                    raise ValueError(f"unknown QoS class {qos!r}")
                t.qos = qos
            if frame_budget_per_s is not None:
                t.frame_budget_per_s = float(frame_budget_per_s)
                t.bucket_frames.reconfigure(t.frame_budget_per_s)
            if byte_budget_per_s is not None:
                t.byte_budget_per_s = float(byte_budget_per_s)
                t.bucket_bytes.reconfigure(t.byte_budget_per_s)
            return t

    def bind_namespace(self, namespace: str, tenant: str) -> None:
        with self._lock:
            t = self._tenants[tenant]
            t.namespaces.add(namespace)
            self._ns_map[namespace] = tenant
            self._masks_stale = True

    def ensure_namespace(self, namespace: str) -> Tenant | None:
        """Reconciler hook: namespace → tenant mapping. An unmapped
        namespace gets a default-QoS, unlimited-quota tenant named
        after it, so every reconciled topology is attributable from
        its first link."""
        if not namespace:
            return None
        with self._lock:
            name = self._ns_map.get(namespace)
            if name is not None:
                return self._tenants.get(name)
        return self.create(namespace)

    def hold(self, name: str) -> None:
        """Migration hold: the tenant's wires get drain budget 0 every
        tick (typed "migration-hold" verdicts, frames kept queued —
        the daemon's ingress high-water backpressure bounds the
        backlog). Idempotent; quotas are untouched."""
        with self._lock:
            self._holds.add(name)

    def release_hold(self, name: str) -> None:
        with self._lock:
            self._holds.discard(name)

    def held(self, name: str) -> bool:
        with self._lock:
            return name in self._holds

    def delete(self, name: str) -> bool:
        """Deregister a tenant: unbind its namespaces, dissolve its
        reserved block (unused reserve rows return to the GLOBAL free
        list; rows still realized inside the former block stay bound to
        their links and drain back to the global pool as they free),
        and drop the registry entry. Admission/QoS enforcement for the
        namespaces ends immediately; accounting row sets are registry-
        derived, so the next `rows_of` of a recreated tenant is exact.
        Idempotent — False when the tenant does not exist. (The
        federation RELEASE step and `kdt tenant delete` both land
        here.)"""
        engine = self.engine
        with engine._lock:
            with self._lock:
                t = self._tenants.pop(name, None)
                if t is None:
                    return False
                for ns in list(t.namespaces):
                    if self._ns_map.get(ns) == name:
                        del self._ns_map[ns]
                self._holds.discard(name)
                freed = list(t.block_free)
                if t.block is not None:
                    self._block_owner[t.block[0]:t.block[1]] = -1
                t.block = None
                t.block_free = []
                self._reserved_free_n -= len(freed)
                self._masks.pop(name, None)
                self._masks_stale = True
            if freed:
                # descending like the global pool: consecutive pops
                # keep handing out consecutive rows (vectorized fold —
                # the extend is one numpy copy, not a per-row append)
                engine._free.extend(sorted(freed, reverse=True))
        self.log.info("tenant deleted %s", _fields(
            tenant=name, freed_reserve=len(freed)))
        return True

    def export_config(self) -> dict:
        """The tenancy section of a checkpoint manifest: quotas, QoS,
        block entitlement (`block_rows` — the reservation re-carves at
        restore, position is an allocation detail), namespace bindings
        and admitted meters. Restored by `checkpoint.load_tenancy` so
        a daemon restart never silently resets tenants to unenforced."""
        with self._lock:
            return {
                "default_qos": self.default_qos,
                "tenants": [{
                    "name": t.name,
                    "qos": t.qos,
                    "frame_budget_per_s": t.frame_budget_per_s,
                    "byte_budget_per_s": t.byte_budget_per_s,
                    "block_rows": int(t.block_rows),
                    "namespaces": sorted(t.namespaces),
                    "admitted_frames": int(t.admitted_frames),
                    "admitted_bytes": int(t.admitted_bytes),
                } for t in self._tenants.values()],
            }

    def get(self, name: str) -> Tenant | None:
        with self._lock:
            return self._tenants.get(name)

    def list(self) -> list[Tenant]:
        with self._lock:
            return list(self._tenants.values())

    def tenant_of_pod_key(self, pod_key: str) -> Tenant | None:
        ns, _, _name = pod_key.partition("/")
        with self._lock:
            t = self._ns_map.get(ns)
            return self._tenants.get(t) if t is not None else None

    # -- engine allocator hooks (engine lock held by the caller) -------

    def alloc_row(self, pod_key: str) -> int | None:
        t = self.tenant_of_pod_key(pod_key)
        if t is None or not t.block_free:
            return None
        row = t.block_free.pop()
        with self._lock:
            self._reserved_free_n -= 1
        return row

    def alloc_pair(self, k1: str, k2: str) -> tuple[int, int] | None:
        t1 = self.tenant_of_pod_key(k1)
        t2 = self.tenant_of_pod_key(k2)
        if t1 is None or t1 is not t2 or len(t1.block_free) < 2:
            return None
        pair = t1.block_free.pop(), t1.block_free.pop()
        with self._lock:
            self._reserved_free_n -= 2
        return pair

    def release_row(self, row: int) -> bool:
        with self._lock:
            # O(1) via the columnar block-owner column — the per-row
            # scan of every tenant's block bounds made freeing N rows
            # O(N·tenants) (dtnscale scost on the alloc path). The
            # positional re-check keeps a stale column entry (block
            # dissolved out-of-band) from resurrecting a dead pool.
            tid = (int(self._block_owner[row])
                   if row < self._block_owner.shape[0] else -1)
            if tid < 0:
                return False
            t = self._tenants.get(self._tenant_names[tid])
            if t is None or t.block is None or \
                    not t.block[0] <= row < t.block[1]:
                return False
            t.block_free.append(row)
            self._reserved_free_n += 1
            return True

    def reserved_free(self) -> int:
        """Unused rows inside tenant blocks — ONE incrementally-
        maintained counter (O(1)); callers on the barrier paths
        (engine._ensure_capacity) read it per operation."""
        with self._lock:
            return self._reserved_free_n

    def reserved_free_rows(self) -> list[int]:
        """Every unused row currently held inside a tenant block. The
        checkpoint writer folds these back into the SAVED free list:
        a reservation is registry state re-carved at restore
        (`load_or_rebuild` → `load_tenancy`), so leaving the rows out
        of the persisted pool would leak them — absent from the global
        free list AND from the freshly-carved blocks — on every
        restart."""
        with self._lock:
            out: list[int] = []
            for t in self._tenants.values():
                out.extend(t.block_free)
            return out

    def on_compact(self, old_rows: np.ndarray, n_active: int,
                   capacity: int) -> None:
        """compact() renumbered every row (new row i held
        ``old_rows[i]``): the old contiguous blocks are gone (their
        active rows moved into [0, n), their unused reserve returned
        to the rebuilt global free list). Each tenant's reservation is
        immediately re-carved at its FULL requested size
        (`block_rows`) — never just the unused remainder, which would
        decay the entitlement on every compact/free cycle (rows
        allocated before the repack live outside the new block and
        drain back to the global pool as they free) — so one tenant's
        repack can never silently strip or shrink another tenant's
        reservation. A re-carve that no longer fits (capacity claimed
        by active rows, shard-locality fragmentation from earlier
        re-carves) leaves that tenant dissolved — with `block_rows`
        remembered, so the NEXT compact or `create(block_edges=...)`
        heals it. The accounting masks permute with the SAME
        vectorized `old_rows` gather the SoA columns used, staying
        exact through the renumbering. Called by engine.compact with
        the ENGINE lock held (re-entrant here — the lock order is
        engine before registry)."""
        from kubedtn_tpu_torch.parallel.partition import tenant_blocks

        engine = self.engine
        with engine._lock, self._lock:
            if not self._masks_stale:
                rt = np.full((capacity,), -1, np.int32)
                rt[:n_active] = self._row_tenant[old_rows]
                self._row_tenant = rt
                for name, m in list(self._masks.items()):
                    nm = np.zeros((capacity,), bool)
                    nm[:n_active] = m[old_rows]
                    self._masks[name] = nm
                self._cap = capacity
            tenants = list(self._tenants.values())
            self._block_owner = np.full(
                (capacity,), -1, np.int32)  # blocks dissolve wholesale
            for t in tenants:
                self._reserved_free_n -= len(t.block_free)
                t.block = None
                t.block_free = []
            # ONE sorted pass over the free list for the whole
            # registry — per-tenant carving would re-sort and rebuild
            # the list T times under the engine lock the tick path's
            # allocator is waiting on
            blks = tenant_blocks(engine._free, engine._state.capacity,
                                 getattr(engine, "shard_count", 1),
                                 [t.block_rows for t in tenants])
            for t, blk in zip(tenants, blks):
                if t.block_rows <= 0:
                    continue
                if blk is None:
                    self.log.warning(
                        "tenant block not re-carved after compact %s",
                        _fields(tenant=t.name, rows=t.block_rows))
                    continue
                t.block = blk
                t.block_free = self._block_free_of(blk)
                self._reserved_free_n += len(t.block_free)
                self._set_block_owner_locked(t, blk)

    # -- admission + QoS (the plane's tick-path surface) ---------------

    def drain_policy(self, base_budget: int, now_s: float):
        """Per-wire drain budget callable for daemon.drain_ingress:
        QoS weight scales the budget; an over-budget tenant's wires get
        0 (skipped this tick, typed verdict recorded, frames kept).
        Tenant → verdict resolution is snapshotted ONCE per tick here,
        not per wire — O(tenants) per tick, O(1) per wire."""
        with self._lock:
            snap = {}
            for name, t in self._tenants.items():
                if name in self._holds:
                    # migration hold: frames queue on their wires until
                    # the cutover redirects (or a rollback releases)
                    snap[name] = (0, "migration-hold")
                elif not t.bucket_frames.ok(now_s):
                    snap[name] = (0, "frame-budget")
                elif not t.bucket_bytes.ok(now_s):
                    snap[name] = (0, "byte-budget")
                else:
                    snap[name] = (max(1, int(base_budget * t.weight)),
                                  None)
            # inside the same lock block as `snap`: a tenant published
            # between the two copies would be in ns_map but not snap
            ns_map = dict(self._ns_map)
        admission = self.admission

        def budget_for(wire) -> int:
            ns, _, _ = wire.pod_key.partition("/")
            name = ns_map.get(ns)
            if name is None:
                return base_budget
            entry = snap.get(name)
            if entry is None:
                return base_budget  # created after the snapshot
            budget, reason = entry
            if budget == 0:
                admission.record(ThrottleVerdict(
                    tenant=name, wire_id=wire.wire_id,
                    queued_frames=len(wire.ingress), reason=reason,
                    at_s=now_s))
            return budget

        return budget_for

    def charge_drained(self, drained, now_s: float) -> None:
        """Debit each drained batch against its tenant's buckets and
        advance the admitted meters (batch-granular: what was drained
        was admitted)."""
        per_tenant: dict[str, tuple[int, int]] = {}
        for wire, _row, lens, _parts in drained:
            t = self.tenant_of_pod_key(wire.pod_key)
            if t is None:
                continue
            frames = len(lens)
            nbytes = int(np.asarray(lens, np.float64).sum())
            f0, b0 = per_tenant.get(t.name, (0, 0))
            per_tenant[t.name] = (f0 + frames, b0 + nbytes)
        if not per_tenant:
            return
        with self._lock:
            for name, (frames, nbytes) in per_tenant.items():
                t = self._tenants.get(name)
                if t is None:
                    continue
                t.admitted_frames += frames
                t.admitted_bytes += nbytes
                t.bucket_frames.charge(frames, now_s)
                t.bucket_bytes.charge(nbytes, now_s)

    # -- columnar accounting maintenance (engine lock held) ------------

    def note_bind(self, row: int, pod_key: str) -> None:
        """Engine hook at row bind: set the owning tenant's mask bit —
        O(1) per row, the incremental half of the columnar accounting.
        Skipped while the masks are stale (the pending rebuild will
        see this row in the registries)."""
        with self._lock:
            if self._masks_stale:
                return
            name = self._ns_map.get(pod_key.partition("/")[0])
            if name is None:
                return
            m = self._masks.get(name)
            if m is None or row >= m.shape[0]:
                # capacity raced ahead of on_capacity (defensive):
                # fall back to a rebuild
                self._masks_stale = True
                return
            m[row] = True
            self._row_tenant[row] = self._tenant_ids[name]

    def note_unbind(self, row: int) -> None:
        """Engine hook at row free: clear the owner's mask bit."""
        with self._lock:
            if self._masks_stale:
                return
            tid = int(self._row_tenant[row]) \
                if row < self._row_tenant.shape[0] else -1
            if tid < 0:
                return
            self._row_tenant[row] = -1
            m = self._masks.get(self._tenant_names[tid])
            if m is not None and row < m.shape[0]:
                m[row] = False

    def on_capacity(self, new_cap: int) -> None:
        """Engine hook at capacity growth: pad the accounting columns
        (vectorized copies, like the SoA growth itself)."""
        with self._lock:
            if new_cap <= self._cap:
                return
            # the block-owner column is allocation state, correct even
            # while the accounting masks are stale — pad unconditionally
            bo = np.full((new_cap,), -1, np.int32)
            bo[:self._block_owner.shape[0]] = self._block_owner
            self._block_owner = bo
            if not self._masks_stale:
                rt = np.full((new_cap,), -1, np.int32)
                rt[:self._row_tenant.shape[0]] = self._row_tenant
                self._row_tenant = rt
                for name, m in list(self._masks.items()):
                    nm = np.zeros((new_cap,), bool)
                    nm[:m.shape[0]] = m
                    self._masks[name] = nm
            self._cap = new_cap

    def _rebuild_masks_locked(self) -> None:
        """ONE pass over the engine registries rebuilds every mask —
        the namespace-binding slow path (tenant create/delete/bind);
        the steady alloc/free path never lands here. Caller holds the
        engine lock AND the registry lock."""
        cap = int(self.engine._state.capacity)
        self._cap = cap
        self._row_tenant = np.full((cap,), -1, np.int32)
        self._masks = {name: np.zeros((cap,), bool)
                       for name in self._tenants}
        for (pod_key, _uid), row in self.engine._rows.items():
            name = self._ns_map.get(pod_key.partition("/")[0])
            if name is None or name not in self._masks:
                continue
            self._masks[name][row] = True
            self._row_tenant[row] = self._tenant_ids[name]
        self._masks_stale = False

    # -- per-tenant slicing (counters + telemetry window ring) ---------

    def rows_of(self, name: str) -> np.ndarray:
        """Current SoA rows owned by the tenant's namespaces — one
        vectorized `flatnonzero` over the tenant's incrementally-
        maintained ownership mask (exact through compact: the mask
        permutes with the engine's own row gather). The historical
        implementation re-walked every engine row per registry
        generation."""
        engine = self.engine
        with engine._lock:
            with self._lock:
                if self._masks_stale:
                    self._rebuild_masks_locked()
                m = self._masks.get(name)
                if m is None:
                    return np.asarray([], np.int64)
                return np.flatnonzero(m).astype(np.int64)

    def tenant_counters(self, plane, name: str) -> dict:
        """This tenant's slice of the plane's cumulative per-edge
        counters (tx/delivered/bytes/drops by cause)."""
        rows = self.rows_of(name)
        c = plane.counters
        cap = np.asarray(c.tx_packets).shape[0]
        rows = rows[rows < cap]

        def s(arr) -> float:
            return float(np.asarray(arr)[rows].sum())

        return {
            "links": int(rows.size),
            "tx_packets": s(c.tx_packets),
            "tx_bytes": s(c.tx_bytes),
            "delivered_packets": s(c.rx_packets),
            "delivered_bytes": s(c.rx_bytes),
            "dropped_loss": s(c.dropped_loss),
            "dropped_queue": s(c.dropped_queue),
            "dropped_ring": s(c.dropped_ring),
            "corrupted": s(c.rx_corrupted),
        }

    def tenant_window(self, plane, name: str,
                      last: int | None = None, window=None) -> dict:
        """This tenant's slice of the telemetry window ring: delivery
        rate and latency percentiles over the covered span (empty dict
        when telemetry is off). `window` takes a precomputed
        `window_sum(...)` result so a caller slicing MANY tenants (the
        metrics collector) reduces the ring once, not once per
        tenant."""
        from kubedtn_tpu_torch import telemetry as tele

        if window is None:
            tel = getattr(plane, "telemetry", None)
            if tel is None:
                return {}
            window = tel.window_sum(last=last)
        total, seconds = window
        rows = self.rows_of(name)
        rows = rows[rows < total.shape[0]]
        t = total[rows].sum(axis=0)
        delivered = float(t[tele.T_DELIVERED])
        secs = max(seconds, 1e-9)
        pcts = tele.percentiles_from_hist(t[tele.T_HIST0:],
                                          qs=(0.5, 0.99))
        return {
            "window_seconds": float(seconds),
            "tx": float(t[tele.T_TX]),
            "delivered": delivered,
            "delivered_pps": delivered / secs,
            "bytes_ps": float(t[tele.T_BYTES]) / secs,
            "dropped_loss": float(t[tele.T_DROP_LOSS]),
            "dropped_queue": float(t[tele.T_DROP_QUEUE]),
            "queue_depth": float(t[tele.T_QDEPTH]),
            "p50_us": pcts["p50_us"],
            "p99_us": pcts["p99_us"],
            # censored = clamped at the open top bucket (render >X)
            "p99_censored": pcts["p99_censored"],
            # the tenant's window histogram on the shared reference
            # ladder, as plain floats: JSON-safe (the migration
            # journal FREEZES this dict at reconcile) and exactly
            # mergeable across planes (slo.fleet)
            "hist": [float(x) for x in t[tele.T_HIST0:]],
        }

    def stats(self, plane, name: str) -> dict:
        """The Local.TenantStats payload: identity + quotas + admitted
        meters + throttle meters + counter slice + window slice."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                raise KeyError(name)
            base = {
                "name": t.name,
                "qos": t.qos,
                "namespaces": sorted(t.namespaces),
                "frame_budget_per_s": t.frame_budget_per_s,
                "byte_budget_per_s": t.byte_budget_per_s,
                "block_lo": t.block[0] if t.block else -1,
                "block_hi": t.block[1] if t.block else -1,
                "admitted_frames": t.admitted_frames,
                "admitted_bytes": t.admitted_bytes,
            }
        base.update(self.admission.stats_for(name))
        if plane is not None:
            base.update(self.tenant_counters(plane, name))
            base["window"] = self.tenant_window(plane, name)
        return base

    # -- tenant-scoped twin forks --------------------------------------

    def tenant_snapshot(self, plane_or_engine, name: str, q: int = 32):
        """Snapshot-fork the live plane (or bare engine) SCOPED to one
        tenant: every edge row outside the tenant's set is deactivated
        in the fork, so a per-tenant what-if sweep answers "what would
        MY slice do" without seeing (or paying for) neighbors. The live
        plane keeps ticking — same consistency barrier as
        twin.snapshot.snapshot_from_plane."""
        import dataclasses as dc

        import torch

        from kubedtn_tpu_torch.twin.snapshot import (snapshot_from_engine,
                                                     snapshot_from_plane)

        rows = self.rows_of(name)
        if hasattr(plane_or_engine, "_tick_lock"):
            snap = snapshot_from_plane(plane_or_engine, q=q)
        else:
            snap = snapshot_from_engine(plane_or_engine, q=q)
        edges = snap.sim.edges
        mask = torch.zeros((edges.capacity,), dtype=torch.bool,
                           device=edges.active.device)
        if rows.size:
            mask[torch.as_tensor(rows, device=mask.device)] = True
        edges = dc.replace(edges, active=edges.active & mask)
        return dc.replace(snap, sim=dc.replace(snap.sim, edges=edges))
