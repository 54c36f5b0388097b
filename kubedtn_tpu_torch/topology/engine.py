"""SimEngine — the node-daemon equivalent, in front of device arrays.

The reference's per-node daemon (reference daemon/kubedtn/handler.go) turns
pod lifecycle and link batches into kernel plumbing: veth pairs, VXLAN
tunnels, qdisc chains. This engine turns the same calls into row operations
on the batched EdgeState device arrays (kubedtn_tpu_torch.ops.edge_state) — one
row per directed link endpoint.

Reference behaviors reproduced exactly:
- SetupPod (handler.go:495-535): unknown pod → "not in topology" and
  delegate; otherwise mark alive (status.src_ip/net_ns + finalizer) and add
  every spec link.
- addLink dispatch (handler.go:316-459): macvlan for peer "localhost" (the
  reference applies NO qdiscs on macvlan links — handler.go:335-345);
  "physical/<ip>" links realized immediately on behalf of the physical
  host; pod-to-pod links gated on peer aliveness — "whoever comes up last
  does the plumbing" (handler.go:386-395), and the plumbing pod's declared
  properties are applied to BOTH ends (common/veth.go:44-62 applies
  link.Properties to self and peer; common/utils.go:39-68 ships the same
  properties to the remote end).
- UpdateLinks (handler.go:634-671): rebuilds only the LOCAL end's qdiscs.
- DestroyPod (handler.go:538-590): clear alive status + finalizers, then
  delete the pod's link rows; deleting a local veth end kills the pair, so
  both directions of its links are deactivated.

Port of kubedtn_tpu/topology/engine.py onto the port's EdgeState. The
state lives on `device` (None = the CUDA card; raises without one) and the
batched link ops update its tensors IN PLACE (ops/edge_state.py). Three
consequences shape this module:

- batches are not padded: no compiler caches shapes here. The update
  batch still takes the same contiguous form as the JAX engine (its
  window check uses the power-of-two padded length) and passes `rows`
  as a host array, which the contiguous update reads on the host;
- every flush, growth, compaction or replacement of the state bumps
  `props_gen`. The live plane keys its host mirror of `props` on it,
  not on tensor identity: an in-place UpdateLinks keeps the identity;
- every op is issued on the calling thread's current CUDA stream. The
  plane and the gRPC threads share the default stream, so an
  UpdateLinks scatter is ordered after a dispatched tick that read the
  old props (the JAX package gets that from immutable snapshots).

Allocation honours tenant blocks as in the JAX package: with a
tenancy.TenantRegistry attached (`engine.tenancy`, set by the registry)
a tenant's rows come from its reserved block first and return to it on
free, and the registry's ownership masks follow every bind, free, growth
and compact. `adopt_rows` / `abandon_rows` bind and free rows by link
identity for the federation's live tenant migration
(kubedtn_tpu_torch.federation.migrate): rows arriving from another plane
land through the same tenant-block allocation, and freed ones return to
their tenant through `_free_row`.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.api.types import (LOCALHOST, PHYSICAL_PREFIX,
                                         Link, Topology)
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger
from kubedtn_tpu_torch.topology.freelist import FreeStack
from kubedtn_tpu_torch.topology.store import (
    NotFoundError,
    TopologyStore,
    retry_on_conflict,
)

# VXLAN VNI base kept for wire-level parity (reference common/constants.go:8,
# common/utils.go:29-36: vni = 5000 + uid).
VXLAN_BASE = 5000

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x00000100000001B3


def link_key_id(pod_key: str, uid: int) -> int:
    """Stable 64-bit key id for one directed link end — FNV-1a over the
    (pod_key, uid) identity. This is the per-row fold_in constant the
    shaping kernels key their draws by (ops/netem.row_keys, as two
    32-bit words of the Philox counter): it depends only on the link's declared
    identity, never on which SoA row realized it, so a tenant's random
    streams are identical in a cohabited plane and in a solo plane of
    just its topology. 64 bits put the birthday bound for an
    accidental id collision — two links sharing one PRNG stream, with
    perfectly correlated loss/jitter/reorder draws, possibly across
    tenants — near 2^32 links, past the roadmap's scale ambition; a
    31-bit id expects one around 65k links."""
    h = _FNV64_OFFSET
    for b in pod_key.encode():
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    for b in int(uid).to_bytes(8, "big", signed=True):
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def vni_from_uid(uid: int) -> int:
    return VXLAN_BASE + uid


def uid_from_vni(vni: int) -> int:
    return vni - VXLAN_BASE


def _locked(fn):
    """Serialize a public engine method on the engine lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


@dataclass
class EngineStats:
    """Per-op latency records — feeds the parity histogram
    kubedtnd_request_duration_milliseconds (reference
    daemon/metrics/latency_histograms.go:5-30)."""

    adds: int = 0
    dels: int = 0
    updates: int = 0
    device_calls: int = 0
    remote_errors: int = 0  # failed peer-daemon completion RPCs
    op_ms: dict[str, list[float]] = field(default_factory=dict)
    observer: object = None  # optional LatencyHistograms

    def observe(self, method: str, ms: float) -> None:
        self.op_ms.setdefault(method, []).append(ms)
        if self.observer is not None:
            self.observer.observe(method, ms)


class SimEngine:
    """Single source of truth for the device-array realization of links."""

    def __init__(self, store: TopologyStore, capacity: int = 1024,
                 node_ip: str = "10.0.0.1", dialer=None,
                 device=None) -> None:
        # One engine serves a 16-thread gRPC pool; all state mutation is
        # serialized here (the reference daemon locks per link uid —
        # common/utils.go:21-26 — but its state lives in the kernel; ours
        # is a single device-array pytree, so a coarse lock is the correct
        # unit).
        self._lock = threading.RLock()
        self.store = store
        self.node_ip = node_ip  # the daemon's HOST_IP equivalent
        self.device = resolve_device(device)
        self._state = es.init_state(capacity, self.device)
        # bumped whenever the state's props may have changed (flush,
        # growth, compact, replacement): the live plane's host mirror of
        # `props` is keyed on it (in-place ops keep tensor identity)
        self.props_gen = 0
        # Pending device ops, coalesced per row with last-writer-wins
        # semantics; flushed as at most THREE batched device calls
        # (delete, apply, update) when device state is actually read.
        # This is the batched answer to the reference's per-link netlink
        # round-trips (handler.go:316-459): a reconcile drain over
        # thousands of topologies becomes one scatter, not thousands.
        # Invariant: a row appears in at most ONE of the three structures.
        self._pending_apply: dict[int, tuple[int, int, int, np.ndarray]] = {}
        self._pending_update: dict[int, np.ndarray] = {}
        self._pending_delete: set[int] = set()
        # host mirror of "does this row shape traffic at all" — the data
        # plane's TCP/IP-bypass guard consults it per frame without a
        # device readback (the role of the redir_disable attach point on
        # each shaped veth, reference common/qdisc.go:285-287)
        self._shaped_rows: set[int] = set()
        # rows touched by control-plane ops since the data plane's last
        # snapshot — the tick's write-back keeps THEIR current dynamic
        # state instead of its pre-snapshot copy (see runtime.py).
        # `_touched_all` is the whole-capacity form compact() raises:
        # the dispatch path treats it as "every row touched" without
        # anyone materializing an O(capacity) Python set
        self._rows_touched: set[int] = set()
        self._touched_all: bool = False
        self.stats = EngineStats()
        # per-action structured logs, the role of the reference's
        # WithField("daemon"/"action") context loggers
        # (reference common/context.go:11-29)
        self.log = get_logger("engine")
        # host-side registries (the daemon's managers):
        self._pod_ids: dict[str, int] = {}   # endpoint name -> node index
        # persistent inverse of _pod_ids, maintained incrementally so
        # barrier bodies (migration fork) never rebuild an O(pods)
        # inverse map under the lock
        self._pod_names: dict[int, str] = {}
        self._rows: dict[tuple[str, int], int] = {}  # (pod_key, uid) -> row
        # persistent inverse of _rows, maintained incrementally so the
        # data-plane tick never rebuilds an O(rows) map under the lock
        self._row_owner: dict[int, tuple[str, int]] = {}
        self._peer: dict[tuple[str, int], tuple[str, int]] = {}
        # columnar free list: O(1) pop/push, vectorized growth/rebuild
        # (the historical Python list was rebuilt O(capacity) on every
        # grow/compact — the dtnscale layer budgets those walks out)
        self._free: FreeStack = FreeStack.from_range(0, capacity)
        # row -> stable 64-bit key id (link_key_id of the owning
        # (pod_key, uid)): the per-row fold_in constant the shaping
        # kernels key their uniforms by (multi-tenant byte-identity).
        # Columnar (capacity-sized uint64, 0 = unbound) so compact()'s
        # renumbering is one vectorized gather, not a per-row FNV
        # re-derive
        self._row_keyid: np.ndarray = np.zeros((capacity,), np.uint64)
        # optional tenancy.TenantRegistry (set by the registry itself):
        # consulted at row allocation so tenant-reserved blocks steer
        # the free list, and at free so block rows return to their pool
        self.tenancy = None
        # >1 when a sharded data plane is attached (set by
        # WireDataPlane.enable_sharding): row allocation colocates link
        # pairs inside one shard block (parallel.partition)
        self.shard_count: int = 1
        self._topology_manager: set[str] = set()  # alive pods (metrics/TopologyManager)
        # placement answers cached per store placement generation
        self._placement_cache: dict[str, tuple[str, str]] = {}
        self._placement_gen: int = -1
        # observers of compact()'s row renumbering (the data plane keeps
        # cumulative per-row counters that must move with the rows)
        self._remap_callbacks: list = []
        # cross-node peer-daemon dialing (reference common/utils.go:53-62,
        # "passthrough:///<nodeIP>:51111"): src_ip -> client with .Update.
        # Injectable for tests / non-default ports; cached per address.
        self._dialer = dialer
        self._peer_clients: dict[str, object] = {}
        self._peer_clients_lock = threading.Lock()

    def _peer_daemon(self, src_ip: str):
        # Raced by the engine's Update path, the per-frame forward path,
        # and (round 5) every per-peer egress sender thread: without the
        # double-checked emplace two racers both dial and one channel
        # leaks open for the process lifetime. The dial itself happens
        # OUTSIDE the lock (it can block on a slow network); the loser's
        # channel is closed if it supports it.
        client = self._peer_clients.get(src_ip)
        if client is not None:
            return client
        if self._dialer is not None:
            client = self._dialer(src_ip)
        else:
            from kubedtn_tpu_torch.wire.client import dial_daemon

            client = dial_daemon(src_ip)
        with self._peer_clients_lock:
            won = self._peer_clients.setdefault(src_ip, client)
        if won is not client:
            close = getattr(client, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        return won

    # -- registries ----------------------------------------------------

    def _pod_id(self, endpoint: str) -> int:
        """pod_id for callers already holding the engine lock — the
        per-link hot path, where re-entering the RLock per endpoint
        measurably slows a 100k-link drain."""
        pid = self._pod_ids.get(endpoint)
        if pid is None:
            pid = self._pod_ids[endpoint] = len(self._pod_ids)
            self._pod_names[pid] = endpoint
        return pid

    @_locked
    def pod_id(self, endpoint: str) -> int:
        """Stable integer id for any endpoint name (pod key, "localhost",
        "physical/<ip>")."""
        return self._pod_id(endpoint)

    def row_of(self, pod_key: str, uid: int) -> int | None:
        return self._rows.get((pod_key, uid))

    def reverse_row(self, pod_key: str, uid: int) -> int | None:
        """Row of the opposite direction of this p2p link, if realized."""
        peer = self._peer.get((pod_key, uid))
        if peer is None:
            return None
        return self._rows.get(peer)

    @property
    def num_active(self) -> int:
        return len(self._rows)

    # -- capacity ------------------------------------------------------

    def _ensure_capacity(self, extra: int) -> None:
        need = self.num_active + extra
        if self.tenancy is not None:
            # rows reserved inside tenant blocks but not yet realized
            # are unavailable to the global pool (one O(1) counter)
            need += self.tenancy.reserved_free()
        cap = self._state.capacity
        if need <= cap:
            return
        new_cap = _next_pow2(need, floor=cap * 2)
        old_cap = self._state.capacity
        # growth commutes with pending row ops (rows are preserved and all
        # pending targets are < old capacity), so no flush is needed here
        self._state = es.grow_state(self._state, new_cap)
        self.props_gen += 1
        # vectorized: new rows slide UNDER the existing free entries
        # (same pop order as the historical list-concat rebuild)
        self._free.prepend_range(old_cap, new_cap)
        kid = np.zeros((new_cap,), np.uint64)
        kid[:old_cap] = self._row_keyid
        self._row_keyid = kid
        if self.tenancy is not None:
            self.tenancy.on_capacity(new_cap)

    # -- device op coalescing -----------------------------------------
    #
    # Mutators enqueue per-row ops; the device sees them as three batched
    # scatters at the next read of `engine.state` (the property flushes).
    # Host registries (_rows/_peer/_free) stay eagerly consistent — they
    # are the source of truth for control flow; the device arrays carry
    # the shaping data plane.

    def _enqueue_apply(self, entries) -> None:
        """entries: (row, uid, src, dst, props_row, shaped)."""
        pa = self._pending_apply
        pu_pop = self._pending_update.pop
        pd_discard = self._pending_delete.discard
        s_add, s_discard = self._shaped_rows.add, self._shaped_rows.discard
        touched = self._rows_touched.add
        for row, uid, src, dst, props, shaped in entries:
            pd_discard(row)
            pu_pop(row, None)
            pa[row] = (uid, src, dst, props)
            (s_add if shaped else s_discard)(row)
            touched(row)

    def _enqueue_delete(self, rows_list: list[int]) -> None:
        for row in rows_list:
            self._pending_apply.pop(row, None)
            self._pending_update.pop(row, None)
            self._pending_delete.add(row)
            self._shaped_rows.discard(row)
            self._rows_touched.add(row)

    def _enqueue_update(self, entries) -> None:
        """entries: (row, props_row, shaped). A row with a pending apply
        merges into it (apply fully overwrites the row anyway)."""
        pa, pa_get = self._pending_apply, self._pending_apply.get
        pu = self._pending_update
        s_add, s_discard = self._shaped_rows.add, self._shaped_rows.discard
        touched = self._rows_touched.add
        for row, props, shaped in entries:
            pending = pa_get(row)
            if pending is not None:
                pa[row] = (*pending[:3], props)
            else:
                pu[row] = props
            (s_add if shaped else s_discard)(row)
            touched(row)

    def is_shaped(self, row: int) -> bool:
        """True when the row's current properties shape traffic (any
        non-zero netem/TBF field)."""
        return row in self._shaped_rows

    def _flush_device_locked(self) -> None:
        """Apply all pending ops as at most three batched in-place
        device calls. Order delete → apply → update is safe: coalescing
        keeps the three row sets disjoint."""
        if not (self._pending_delete or self._pending_apply
                or self._pending_update):
            return
        self.props_gen += 1
        if self._pending_delete:
            rows = np.array(sorted(self._pending_delete), np.int32)
            self._pending_delete.clear()
            es.delete_links(self._state, rows, np.ones(len(rows), bool))
            self.stats.device_calls += 1
        if self._pending_apply:
            items = sorted(self._pending_apply.items())
            self._pending_apply.clear()
            n = len(items)
            rows = np.fromiter((r for r, _ in items), np.int32, n)
            uids = np.fromiter((e[0] for _, e in items), np.int32, n)
            src = np.fromiter((e[1] for _, e in items), np.int32, n)
            dst = np.fromiter((e[2] for _, e in items), np.int32, n)
            props = np.stack([e[3] for _, e in items]).astype(np.float32)
            es.apply_links(self._state, rows, uids, src, dst, props,
                           np.ones(n, bool))
            self.stats.device_calls += 1
        if self._pending_update:
            items = sorted(self._pending_update.items())
            self._pending_update.clear()
            n = len(items)
            rows = np.fromiter((r for r, _ in items), np.int32, n)
            props = np.stack([p for _, p in items]).astype(np.float32)
            # consecutive-row batches (the allocator hands out consecutive
            # rows, so whole-topology updates usually qualify) take the
            # gather/scatter-free streaming path. The window check uses
            # the JAX engine's padded length, so both choose the same form
            contig = _contiguous_padded(rows, self._state.capacity)
            es.update_links(self._state, rows, props, np.ones(n, bool),
                            contiguous=contig)
            self.stats.device_calls += 1

    def flush(self) -> None:
        """Force pending device ops out (normally lazy via `state`)."""
        with self._lock:
            self._flush_device_locked()

    def warm_kernels(self) -> None:
        """Flush, then launch the shaping kernel K1 once on the state
        (an all-idle step: no lane carries a packet, the result is
        dropped) and wait for the card, so the first tick or ping does
        not pay the kernel library's build and load."""
        from kubedtn_tpu_torch.ops import netem

        with self._lock:
            self._flush_device_locked()
            st = self._state
            E = st.capacity
            zeros = torch.zeros(E, dtype=torch.float32, device=st.device)
            have = torch.zeros(E, dtype=torch.bool, device=st.device)
            gen = torch.Generator(device=st.device).manual_seed(0)
            netem.shape_step_nodonate(st, zeros, have, zeros, gen)
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)

    @property
    def state(self):
        """Device edge state, with pending ops flushed — every external
        read observes the registries' current truth."""
        with self._lock:
            self._flush_device_locked()
            return self._state

    @state.setter
    def state(self, value) -> None:
        # assignment replaces the arrays but keeps pending ops queued:
        # they encode registry changes not yet realized on device and
        # apply row-wise to whatever arrays are current at the next flush
        with self._lock:
            self._state = value
            self.props_gen += 1

    # -- pod / link lifecycle (the Local gRPC surface) ----------------

    def get_pod(self, name: str, ns: str = "default") -> Topology:
        """Local.Get equivalent (handler.go:50-60)."""
        return self.store.get(ns or "default", name)

    @_locked
    def set_alive(self, name: str, ns: str, src_ip: str, net_ns: str) -> bool:
        """Local.SetAlive equivalent (handler.go:90-147): write placement
        into status, manage the finalizer, register with the topology
        manager. Alive ⇔ both src_ip and net_ns set."""
        from kubedtn_tpu_torch import GROUP_VERSION

        alive = bool(src_ip) and bool(net_ns)

        def txn_status():
            topo = self.store.get(ns, name)
            topo.status.src_ip = src_ip
            topo.status.net_ns = net_ns
            self.store.update_status(topo)

        retry_on_conflict(txn_status)

        def txn_meta():
            topo = self.store.get(ns, name)
            if alive:
                if GROUP_VERSION not in topo.finalizers:
                    topo.finalizers.append(GROUP_VERSION)
            else:
                # remove only our own finalizer — foreign holders keep the
                # object alive (the reference removes just its entry,
                # handler.go:125-140)
                topo.finalizers = [f for f in topo.finalizers
                                   if f != GROUP_VERSION]
            self.store.update(topo)

        retry_on_conflict(txn_meta)

        key = f"{ns or 'default'}/{name}"
        if alive:
            self._topology_manager.add(key)
        else:
            self._topology_manager.discard(key)
        return True

    def setup_pod(self, name: str, ns: str = "default",
                  net_ns: str = "") -> bool:
        """Local.SetupPod equivalent (handler.go:495-535).

        Deliberately NOT @_locked: every sub-operation takes the engine
        lock itself, and add_links must issue its cross-node completion
        RPCs with the lock released — holding it here would let two nodes'
        SetupPods deadlock dialing each other (the scenario behind the
        reference's unlock-early discipline, handler.go:442-446).

        Returns add_links' verdict: a failed cross-node completion RPC
        surfaces as False so the caller (gRPC SetupPod → CNI, or a
        reconcile pass) can retry instead of recording the link as
        realized (the reference propagates the same failure,
        handler.go:524-532)."""
        t0 = time.perf_counter()
        try:
            topo = self.get_pod(name, ns)
        except NotFoundError:
            # Not a topology pod: CNI delegates to the next plugin.
            return True
        self.set_alive(name, ns, self.node_ip, net_ns or f"/run/netns/{name}")
        topo = self.get_pod(name, ns)
        ok = self.add_links(topo, topo.spec.links)
        ms = (time.perf_counter() - t0) * 1e3
        self.stats.observe("setup", ms)
        self.log.info("setup_pod %s", _fields(
            pod=f"{ns or 'default'}/{name}", links=len(topo.spec.links),
            ok=ok, ms=round(ms, 2)))
        return ok

    def destroy_pod(self, name: str, ns: str = "default") -> bool:
        """Local.DestroyPod equivalent (handler.go:538-590). Not @_locked
        for the same reason as setup_pod — sub-operations self-lock."""
        key = f"{ns or 'default'}/{name}"
        self._topology_manager.discard(key)
        try:
            topo = self.get_pod(name, ns)
        except NotFoundError:
            return False
        # Fetch links BEFORE clearing alive status: dropping the finalizer
        # may complete a pending CR deletion, after which the object is gone
        # (the reference reads localPod first for the same reason —
        # handler.go:559-586).
        links = topo.spec.links
        self.set_alive(name, ns, "", "")
        self.del_links(topo, links)
        return True

    def _refresh_placement_cache(self) -> None:
        """Drop cached placements if any placement may have moved. Checked
        once per engine operation, not per link — the store lock behind
        placement_generation is itself measurable at 100k links."""
        gen = self.store.placement_generation
        if gen != self._placement_gen:
            self._placement_cache.clear()
            self._placement_gen = gen

    def _placement_cached(self, pod_key: str) -> tuple[str, str]:
        """(src_ip, net_ns) via the generation-validated cache; the caller
        must have called _refresh_placement_cache() this operation."""
        hit = self._placement_cache.get(pod_key)
        if hit is None:
            ns, _, name = pod_key.partition("/")
            try:
                hit = self.store.peek_placement(ns, name)
            except NotFoundError:
                hit = ("", "")
            self._placement_cache[pod_key] = hit
        return hit

    def _placement(self, pod_key: str) -> tuple[str, str]:
        """(src_ip, net_ns) for a pod key, cached against the store's
        placement generation — a 100k-link drain asks hundreds of times
        per topology and placement only moves on CNI events, so the cache
        typically survives the whole drain (status copy-backs don't bump
        the generation)."""
        self._refresh_placement_cache()
        return self._placement_cached(pod_key)

    @_locked
    def is_alive(self, pod_key: str) -> bool:
        # _locked: the placement cache is engine state — every mutator of
        # it must hold the engine lock like the other registries do.
        src_ip, net_ns = self._placement(pod_key)
        return bool(src_ip) and bool(net_ns)

    def add_links(self, topo: Topology, links: list[Link]) -> bool:
        """Local.AddLinks equivalent: the reference's per-link dispatch
        (handler.go:316-459) collapsed into one batched device op, plus
        peer-daemon completion RPCs for cross-node links issued AFTER the
        engine lock is released — the reference's explicit unlock-before-
        RPC deadlock avoidance (handler.go:442-446)."""
        remote_calls = self._add_links_locked(topo, links)
        ok = self.complete_remote(remote_calls, pod_key=topo.key)
        if links:
            self.log.debug("add_links %s", _fields(
                action="add", pod=topo.key, links=len(links),
                remote_calls=len(remote_calls), ok=ok))
        return ok

    def complete_remote(self, remote_calls, pod_key: str = "",
                        action: str = "add") -> bool:
        """Issue the cross-node completion RPCs `_add_links_locked`
        returned — ALWAYS with the engine lock released (the reference's
        unlock-before-RPC deadlock avoidance, handler.go:442-446). The
        one completion loop shared by `add_links` and the planned-update
        stager's round apply."""
        ok = True
        for src_ip, remote_pod in remote_calls:
            try:
                resp = self._peer_daemon(src_ip).Update(remote_pod)
                ok = ok and bool(resp.response)
            except Exception as e:
                self.stats.remote_errors += 1
                self.log.warning("remote completion failed %s", _fields(
                    action=action, pod=pod_key, peer_daemon=src_ip,
                    error=type(e).__name__))
                ok = False
        return ok

    @_locked
    def _add_links_locked(self, topo: Topology, links: list[Link]):
        t0 = time.perf_counter()
        local_key = topo.key
        self._ensure_capacity(2 * len(links))
        entries: list[tuple[int, int, int, int, np.ndarray, bool]] = []
        remote_calls: list[tuple[str, object]] = []
        # peer-pod name → "<ns>/<name>" key, built once per peer per call
        # (the f-string per link was itself visible at 100k-link scale)
        peer_keys: dict[str, str] = {}
        ns_prefix = topo.namespace + "/"
        local_pid = self._pod_id(local_key)
        self._refresh_placement_cache()
        # hot-loop locals: at 1M links every attribute/method lookup in
        # this loop is a measurable slice of realize time
        rows_map = self._rows
        alloc = self._alloc
        pod_id = self._pod_id
        peer_map = self._peer
        props_pack = es.props_row_and_shaped
        entries_append = entries.append
        node_ip = self.node_ip
        for link in links:
            uid_ = link.uid
            peer_pod = link.peer_pod
            if (peer_pod != LOCALHOST
                    and not peer_pod.startswith(PHYSICAL_PREFIX)):
                # common case first: a pod-to-pod link
                peer_key = peer_keys.get(peer_pod)
                if peer_key is None:
                    peer_key = peer_keys[peer_pod] = ns_prefix + peer_pod
                peer_src_ip, peer_net_ns = self._placement_cached(peer_key)
                if not (peer_src_ip and peer_net_ns):
                    # Peer not up: the peer plumbs both ends when it
                    # arrives (handler.go:389-395)
                    continue
                if peer_src_ip and node_ip and peer_src_ip != node_ip:
                    # Branch D, cross-node — same semantics as the slow
                    # path below (handler.go:419-453)
                    if (local_key, uid_) not in rows_map:
                        row = alloc(local_key, uid_)
                        props, shaped = props_pack(link.properties)
                        entries_append((row, uid_, local_pid,
                                        pod_id(f"vtep/{peer_src_ip}"),
                                        props, shaped))
                    from kubedtn_tpu_torch.wire import proto as pb

                    remote_calls.append((peer_src_ip, pb.RemotePod(
                        net_ns="", intf_name=link.peer_intf,
                        intf_ip=link.peer_ip, peer_vtep=node_ip,
                        vni=vni_from_uid(uid_),
                        kube_ns=topo.namespace, name=peer_pod,
                        properties=pb.props_to_proto(link.properties),
                    )))
                    continue
                lk = (local_key, uid_)
                pk = (peer_key, uid_)
                if lk in rows_map and pk in rows_map:
                    # both ends realized (common/veth.go:73-76)
                    continue
                # both alive same-node: plumb BOTH directions
                # (common/veth.go:44-62, common/utils.go:39-68).
                # Sharded planes colocate the pair in one shard block
                # (_alloc_link_pair) so a link's two directed rows never
                # straddle the cross-shard mailbox boundary.
                props, shaped = props_pack(link.properties)
                peer_pid = pod_id(peer_key)
                row, prow = self._alloc_link_pair(local_key, peer_key,
                                                  uid_)
                entries_append((row, uid_, local_pid, peer_pid, props,
                                shaped))
                entries_append((prow, uid_, peer_pid, local_pid, props,
                                shaped))
                peer_map[lk] = pk
                peer_map[pk] = lk
                continue
            if link.is_macvlan():
                # macvlan uplink: realized immediately, NO shaping applied
                # (reference handler.go:335-345 never touches qdiscs here).
                row = self._alloc(local_key, link.uid)
                entries.append((
                    row, link.uid, local_pid, self._pod_id(LOCALHOST),
                    np.zeros((es.NPROP,), np.float32), False,
                ))
                continue
            if link.is_physical():
                # Physical-virtual link: daemon handles both perspectives
                # locally (handler.go:348-369); the physical host is always
                # "alive".
                row = self._alloc(local_key, link.uid)
                props, shaped = es.props_row_and_shaped(link.properties)
                entries.append((row, link.uid, local_pid,
                                self._pod_id(link.peer_pod), props, shaped))
                continue

        self._enqueue_apply(entries)
        self.stats.adds += len(entries)
        self.stats.observe("add", (time.perf_counter() - t0) * 1e3)
        return remote_calls

    @_locked
    def del_links(self, topo: Topology, links: list[Link]) -> bool:
        """Local.DelLinks equivalent (handler.go:461-492, 613-632).

        Removing a local veth end destroys the pair, so the peer-direction
        row of each link dies with it.
        """
        t0 = time.perf_counter()
        local_key = topo.key
        rows: list[int] = []
        for link in links:
            row = self._rows.pop((local_key, link.uid), None)
            self._peer.pop((local_key, link.uid), None)
            if row is not None:
                rows.append(row)
                self._free_row(row)
                self._row_owner.pop(row, None)
            if not (link.is_macvlan() or link.is_physical()):
                peer_key = f"{topo.namespace}/{link.peer_pod}"
                prow = self._rows.pop((peer_key, link.uid), None)
                self._peer.pop((peer_key, link.uid), None)
                if prow is not None:
                    rows.append(prow)
                    self._free_row(prow)
                    self._row_owner.pop(prow, None)
        self._enqueue_delete(rows)
        self.stats.dels += len(rows)
        self.stats.observe("del", (time.perf_counter() - t0) * 1e3)
        if rows:
            self.log.debug("del_links %s", _fields(
                action="delete", pod=local_key, rows=len(rows)))
        return True

    @_locked
    def update_links(self, topo: Topology, links: list[Link]) -> bool:
        """Local.UpdateLinks equivalent (handler.go:634-671): rebuild only
        the LOCAL end's shaping, leaving the peer direction untouched."""
        t0 = time.perf_counter()
        local_key = topo.key
        entries: list[tuple[int, np.ndarray, bool]] = []
        for link in links:
            row = self._rows.get((local_key, link.uid))
            if row is None:
                continue
            entries.append((row, *es.props_row_and_shaped(link.properties)))
        self._enqueue_update(entries)
        self.stats.updates += len(entries)
        self.stats.observe("update", (time.perf_counter() - t0) * 1e3)
        if entries:
            self.log.debug("update_links %s", _fields(
                action="update", pod=local_key, rows=len(entries)))
        return True

    @_locked
    def remote_update(self, name: str, ns: str, uid: int, intf_name: str,
                      intf_ip: str, peer_vtep: str, props) -> bool:
        """Remote.Update equivalent (reference handler.go:149-198): a peer
        daemon asks us to realize our end of a cross-node link, identified
        by VNI→uid. The far end is the peer's VTEP, not a local pod."""
        del intf_name, intf_ip  # interface identity lives in the CR spec
        t0 = time.perf_counter()
        pod_key = f"{ns or 'default'}/{name}"
        self._ensure_capacity(1)
        row = self._alloc(pod_key, uid)
        prow, shaped = es.props_row_and_shaped(props)
        entry = (row, uid, self._pod_id(pod_key),
                 self._pod_id(f"vtep/{peer_vtep}"), prow, shaped)
        self._enqueue_apply([entry])
        self.stats.observe("remoteUpdate", (time.perf_counter() - t0) * 1e3)
        return True

    def _bind_row(self, pod_key: str, uid: int, row: int) -> None:
        k = (pod_key, uid)
        self._rows[k] = row
        self._row_owner[row] = k
        self._row_keyid[row] = link_key_id(pod_key, uid)
        if self.tenancy is not None:
            # the per-tenant ownership masks follow every bind (O(1))
            self.tenancy.note_bind(row, pod_key)

    def _alloc(self, pod_key: str, uid: int) -> int:
        k = (pod_key, uid)
        if k in self._rows:
            return self._rows[k]  # idempotent re-plumb (SetupVeth semantics)
        row = None
        if self.tenancy is not None:
            # the tenant's reserved block first; the global free list
            # when the tenant has no block or it is full
            row = self.tenancy.alloc_row(pod_key)
        if row is None:
            row = self._free.pop()
        self._bind_row(pod_key, uid, row)
        return row

    def _free_row(self, row: int) -> None:
        """Return a freed row to its pool: the owning tenant's block
        free list when the row sits in a reserved block, the global
        free list otherwise."""
        self._row_keyid[row] = 0
        if self.tenancy is not None:
            self.tenancy.note_unbind(row)
            if self.tenancy.release_row(row):
                return
        self._free.push(row)

    def _alloc_link_pair(self, k1: str, k2: str, uid: int):
        """Allocate both directed rows of one link, colocated in one
        shard block when the data plane is sharded (shard_count > 1,
        set by WireDataPlane.enable_sharding): frames between colocated
        endpoints never ride the cross-shard mailbox. Idempotent like
        _alloc; unsharded behavior is byte-for-byte the historical
        two-pop path. Tenant-reserved blocks take precedence: both
        directions of an intra-tenant link land inside the tenant's
        block."""
        a = self._rows.get((k1, uid))
        b = self._rows.get((k2, uid))
        if a is not None and b is not None:
            return a, b
        if a is None and b is None and self.tenancy is not None:
            pair = self.tenancy.alloc_pair(k1, k2)
            if pair is not None:
                self._bind_row(k1, uid, pair[0])
                self._bind_row(k2, uid, pair[1])
                return pair
        S = getattr(self, "shard_count", 1)
        if (a is None and b is None and S > 1 and len(self._free) >= 2
                and self._state.capacity % S == 0):
            from kubedtn_tpu_torch.parallel.partition import pick_pair_rows

            r1, r2 = pick_pair_rows(self._free, self._state.capacity, S)
            self._bind_row(k1, uid, r1)
            self._bind_row(k2, uid, r2)
            return r1, r2
        return self._alloc(k1, uid), self._alloc(k2, uid)

    @_locked
    def adopt_rows(self, entries, peers=None) -> list[int]:
        """Bind + realize rows arriving from ANOTHER plane (live tenant
        migration, federation.migrate): `entries` are (pod_key, uid,
        src_name, dst_name, props_row, shaped) with node NAMES instead
        of ids — ids are a per-engine numbering, names are the portable
        identity. Idempotent per (pod_key, uid) like `_alloc` (a resumed
        RESTORE re-adopts only what is missing). `peers` lists
        ((pod_key, uid), (peer_key, peer_uid)) pairs to re-establish in
        the peer registry. Props land bit-exact (the captured f32 row,
        never re-parsed); the caller scatters the dynamic shaping
        columns separately, after flushing the init this enqueues.
        Returns the bound row per entry, in order. Allocation honors
        tenant blocks: with a tenancy registry attached, adopted rows
        carve into the owning tenant's contiguous reservation exactly
        like native allocations."""
        self._ensure_capacity(len(entries))
        rows: list[int] = []
        apply_entries = []
        for pod_key, uid, src_name, dst_name, props, shaped in entries:
            k = (pod_key, int(uid))
            row = self._rows.get(k)
            if row is None:
                row = self._alloc(pod_key, int(uid))
                apply_entries.append((
                    row, int(uid), self._pod_id(src_name),
                    self._pod_id(dst_name),
                    np.asarray(props, np.float32), bool(shaped)))
            rows.append(row)
        for k, pk in (peers or ()):
            k = (k[0], int(k[1]))
            pk = (pk[0], int(pk[1]))
            self._peer[k] = pk
            self._peer[pk] = k
        self._enqueue_apply(apply_entries)
        self.stats.adds += len(apply_entries)
        if apply_entries:
            self.log.info("adopt_rows %s", _fields(
                action="adopt", rows=len(apply_entries),
                total=len(entries)))
        return rows

    @_locked
    def abandon_rows(self, keys) -> int:
        """Release rows by (pod_key, uid) identity without a Topology
        object — the migration RELEASE/rollback path (the rows' links
        live on in another plane's state; this end just frees the
        realization). Freed block rows return to their tenant pool via
        `_free_row` as usual. Idempotent; returns rows freed."""
        rows: list[int] = []
        for k in keys:
            k = (k[0], int(k[1]))
            row = self._rows.pop(k, None)
            self._peer.pop(k, None)
            if row is not None:
                rows.append(row)
                self._free_row(row)
                self._row_owner.pop(row, None)
        self._enqueue_delete(rows)
        self.stats.dels += len(rows)
        if rows:
            self.log.info("abandon_rows %s", _fields(
                action="abandon", rows=len(rows)))
        return len(rows)

    def on_rows_remapped(self, cb) -> None:
        """Register cb(old_rows_np, n_active): called after compact()
        renumbers rows (new row i held old row old_rows_np[i]). Held by
        WEAK reference: a replaced data plane must not be kept alive by
        the engine, nor have its stale counters permuted forever."""
        import weakref

        ref = (weakref.WeakMethod(cb) if hasattr(cb, "__self__")
               else weakref.ref(cb))
        with self._lock:
            self._remap_callbacks.append(ref)

    def compact(self) -> dict:
        """Repack active rows to [0, n): defragmentation after churn.

        The allocator recycles freed rows LIFO, so heavy delete/add churn
        scatters a topology's rows across capacity and whole-drain update
        batches fall off the contiguous streaming fast path (they remain
        correct via the scatter path, just slower). compact() restores
        the dense layout with ONE device gather (SURVEY §7 hard part (a):
        capacity padding + free-list compaction). Registered observers
        (the data plane's per-row counters) are remapped OUTSIDE the
        engine lock — a tick racing the callback may smear at most one
        tick of counter increments across the renumbering.

        The whole pass (device gather + registry rebuild + observer
        remap) reports into the owning plane's pause ledger (cause
        "compact" — the engine carries `pauses` as a back-reference the
        plane sets, None for engine-only embedders).
        """
        t_pause0 = time.perf_counter()
        with self._lock:
            self._flush_device_locked()
            items = sorted(self._rows.items())
            n = len(items)
            cap = self._state.capacity
            old_rows = np.fromiter((r for _, r in items), np.int64, n)
            perm = np.zeros((cap,), np.int32)
            perm[:n] = old_rows
            self._state = es.compact_state(self._state, perm, n)
            self.props_gen += 1
            # ONE pass over the sorted registry rebuilds both row maps
            # (new row i == position i in sorted-key order); every
            # other row-keyed column remaps as a vectorized gather
            # through `new_of_old` — the historical per-row dict
            # rebuilds and FNV re-derives were each their own
            # O(active-rows) Python walk under the engine lock
            rows_new: dict[tuple[str, int], int] = {}
            owner_new: dict[int, tuple[str, int]] = {}
            for i, (k, _r) in enumerate(items):
                rows_new[k] = i
                owner_new[i] = k
            self._rows = rows_new
            self._row_owner = owner_new
            new_of_old = np.full((cap,), -1, np.int64)
            new_of_old[old_rows] = np.arange(n)
            if self._shaped_rows:
                shaped_old = np.fromiter(self._shaped_rows, np.int64,
                                         len(self._shaped_rows))
                self._shaped_rows = set(
                    new_of_old[shaped_old].tolist())
                self._shaped_rows.discard(-1)
            # key ids are identity-derived and identities are
            # unchanged: the remap is one gather of the column
            kid = np.zeros((cap,), np.uint64)
            kid[:n] = self._row_keyid[old_rows]
            self._row_keyid = kid
            self._free = FreeStack.from_range(n, cap)
            if self.tenancy is not None:
                # tenant blocks do not survive the repack: the registry
                # re-carves each reservation from the rebuilt free list
                # and permutes its ownership masks with old_rows
                self.tenancy.on_compact(old_rows, n, cap)
            # the data plane's next write-back must not resurrect
            # pre-compact dynamic state for any row — raised as a flag,
            # never materialized as an O(capacity) Python set
            self._rows_touched.clear()
            self._touched_all = True
            moved = int((old_rows != np.arange(n)).sum())
            live = []
            for ref in self._remap_callbacks:
                cb = ref()
                if cb is not None:
                    live.append(cb)
            self._remap_callbacks = [r for r in self._remap_callbacks
                                     if r() is not None]
        for cb in live:
            cb(old_rows, n)
        pauses = getattr(self, "pauses", None)
        if pauses is not None:
            pauses.record("compact", time.perf_counter() - t_pause0,
                          rows=n, moved=moved)
        self.log.info("compact %s", _fields(action="compact", active=n,
                                            moved=moved))
        return {"active": n, "moved": moved}

    # -- queries -------------------------------------------------------

    @_locked
    def metrics_snapshot(self, limit: int | None = None):
        """(realized_snapshot(limit), total_active, active_rows_np) in ONE
        locked read — the scrape's truncation count and node totals must
        be consistent with the snapshot they accompany."""
        snap = self.realized_snapshot(limit)
        rows = np.fromiter(self._rows.values(), np.int64, len(self._rows))
        return snap, len(self._rows), rows

    @_locked
    def realized_snapshot(self, limit: int | None = None
                          ) -> list[tuple[str, int, int, int | None]]:
        """(pod_key, uid, row, reverse_row) for realized link ends in
        sorted-key order, taken under the engine lock — the safe read for
        concurrent metrics scrapes (a gRPC worker may be mutating the
        registries). With `limit`, only the first `limit` ends are built
        via a heap (O(n log limit)) so a capped 100k-row scrape doesn't
        hold the lock for a full sort."""
        if limit is None or limit >= len(self._rows):
            items = sorted(self._rows.items())
        else:
            import heapq

            items = heapq.nsmallest(limit, self._rows.items())
        out = []
        for (pod_key, uid), row in items:
            peer = self._peer.get((pod_key, uid))
            rev = self._rows.get(peer) if peer is not None else None
            out.append((pod_key, uid, row, rev))
        return out

    def link_row(self, pod_key: str, uid: int) -> dict | None:
        """Host-side readout of one directed link's realized state."""
        row = self._rows.get((pod_key, uid))
        if row is None:
            return None
        state = self.state  # one flush+snapshot
        props = state.props[row].cpu().numpy()
        return {
            "row": row,
            "uid": int(state.uid[row]),
            "active": bool(state.active[row]),
            **{name: float(props[i]) for i, name in enumerate(es.PROP_NAMES)},
        }

    @_locked
    def ping(self, a: str, b: str, uid: int, size_bytes: float = 84.0,
             ns: str = "default", seed: int = 0) -> dict:
        """Ping-equivalent probe: push one ICMP-sized packet each way
        through the shaping kernels and report the RTT — the analogue of
        the reference's e2e smoke test (reference hack/test-3node.sh:1-10).
        """

        from kubedtn_tpu_torch.ops import netem

        akey, bkey = f"{ns}/{a}", f"{ns}/{b}"
        ra = self._rows.get((akey, uid))
        rb = self._rows.get((bkey, uid))
        if ra is None or rb is None:
            return {"reachable": False, "rtt_us": float("inf")}
        state = self.state
        # kernel K1 on the card, without donation: an in-flight tick may
        # hold these tensors in its lock-free snapshot
        sizes, have, t0, gen = ping_inputs(state, (ra, rb), size_bytes,
                                           uid, seed)
        self.state, res = netem.shape_step_nodonate(state, sizes, have,
                                                    t0, gen)
        d_ab = float(res.depart_us[ra])
        d_ba = float(res.depart_us[rb])
        delivered = bool(res.delivered[ra]) and bool(res.delivered[rb])
        return {
            "reachable": delivered,
            "rtt_us": d_ab + d_ba if delivered else float("inf"),
            "fwd_us": d_ab,
            "rev_us": d_ba,
        }

    def trace(self, a: str, b: str, ns: str = "default",
              max_hops: int = 16) -> dict:
        """Traceroute-equivalent: walk the device-computed shortest path
        from pod a to pod b hop by hop, reporting each traversed link's
        uid and configured latency plus the path total. Multi-hop — where
        ping probes ONE direct link, trace routes across the whole fabric
        (the role `traceroute` plays next to `ping` in the reference's
        manual test workflow)."""
        from kubedtn_tpu_torch.ops import routing as R

        akey, bkey = f"{ns}/{a}", f"{ns}/{b}"
        with self._lock:
            # ids and state under ONE lock hold: a pod registered between
            # the two reads would put node ids >= n_nodes into the edge
            # arrays, which the routing gathers silently clamp
            ids = dict(self._pod_ids)
            state = self.state  # flushes pending control-plane ops
        if akey not in ids or bkey not in ids:
            return {"reachable": False, "hops": [],
                    "error": "unknown pod(s)"}
        n_nodes = max(ids.values()) + 1
        dist, nh = R.recompute_routes(state, n_nodes, max_hops=max_hops)
        nh_np = nh.cpu().numpy()
        dstv = state.dst.cpu().numpy()
        uid_np = state.uid.cpu().numpy()
        lat = state.props[:, es.P_LATENCY_US].cpu().numpy()
        names = {v: k for k, v in ids.items()}
        cur, goal = ids[akey], ids[bkey]
        reachable = bool(torch.isfinite(dist[cur, goal]))
        hops = []
        total = 0.0
        if reachable:
            # a reachable shortest path has < n_nodes edges; the bound
            # guards the walk against float-tie pathologies in nh
            for _ in range(n_nodes):
                if cur == goal:
                    break
                edge = int(nh_np[cur, goal])
                if edge < 0:
                    return {"reachable": False, "hops": hops,
                            "error": "next-hop walk diverged "
                                     "(finite dist but no next hop)"}
                nxt = int(dstv[edge])
                total += float(lat[edge])
                hops.append({
                    "from": names.get(cur, str(cur)),
                    "to": names.get(nxt, str(nxt)),
                    "uid": int(uid_np[edge]),
                    "latency_us": float(lat[edge]),
                })
                cur = nxt
            if cur != goal:
                # float-tie pathologies in nh (e.g. zero-latency
                # equal-cost cycles under the tie epsilon) can make the
                # walk loop without reaching goal; report, don't crash
                return {"reachable": False, "hops": hops,
                        "error": "next-hop walk diverged from dist"}
        return {"reachable": reachable, "hops": hops,
                "total_latency_us": total}


def ping_inputs(state, rows, size_bytes: float, uid: int, seed: int):
    """The inputs of ping's one shaping step over `state`: (sizes, have,
    t_arrival, generator), one `size_bytes` packet on each of `rows`.
    The generator is seeded from one Philox call under the seed's key
    with the link uid in the counter, so two pings with one seed on
    different links draw different bits."""
    from kubedtn_tpu_torch.ops.cuda import philox

    E, dev = state.capacity, state.device
    sizes = torch.full((E,), float(size_bytes), dtype=torch.float32,
                       device=dev)
    have = torch.zeros((E,), dtype=torch.bool, device=dev)
    have[torch.as_tensor(list(rows), device=dev)] = True
    t0 = torch.zeros((E,), dtype=torch.float32, device=dev)
    w = philox.philox4x32_words((uid & philox.MASK32, 0, 0, 0),
                                (seed & philox.MASK32,
                                 (seed >> 32) & philox.MASK32))
    gen = torch.Generator(device=dev).manual_seed(
        (w[0] | (w[1] << 32)) & 0x7FFFFFFFFFFFFFFF)
    return sizes, have, t0, gen


def _contiguous_padded(rows: np.ndarray, capacity: int) -> bool:
    """es.contiguous_window over the batch as the JAX engine pads it
    (power-of-two lane count, padding lanes invalid): consecutive rows
    whose PADDED window fits the capacity."""
    n = len(rows)
    b = _next_pow2(max(n, 1))
    padded = np.zeros(b, rows.dtype)
    padded[:n] = rows
    valid = np.zeros(b, bool)
    valid[:n] = True
    return es.contiguous_window(padded, valid, capacity)
