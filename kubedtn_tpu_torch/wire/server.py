"""The daemon: gRPC services in front of the SimEngine.

Port of kubedtn_tpu/wire/server.py. Plays the role of the reference's
per-node daemon process (reference daemon/main.go, daemon/kubedtn/) for
clients speaking its exact wire protocol on the same default port 51111:
`Local` (CNI plugin + controller surface), `Remote` (peer daemons),
`WireProtocol` (per-frame tunnel). Requests become engine calls; the
"kernel plumbing" they used to trigger is device tensor state.

The grpc-wire capability — attach an external packet source/sink to a
simulated link (reference daemon/grpcwire/grpcwire.go) — is the live
plane's ingress/egress: frames sent via SendToOnce/SendToStream/the bulk
RPCs queue onto their wire for the next tick; frames the plane delivers
to a wire queue on its egress for pickup.

`grpc` and the port's `proto` module are imported only where they are
needed (the handlers, `make_server`), so the Daemon, its WireManager and
the live plane import and run without either package. `_add_wire`
accepts any object with WireDef's attribute names.

Delivery depends on the wire's kind. A local attachment wire (no
`peer_ip`) takes pod-origin frames into the simulation (ingress). A
cross-daemon wire (`peer_ip` set) receives frames from its peer daemon,
already shaped on the sender's egress row: SendToOnce / SendToStream /
SendToBulk put them straight on the pod side (egress). InjectFrame and
InjectBulk are pod-origin ingress on every wire. The plane's released
frames for a cross wire cross to the peer through runtime's per-peer
senders (coalesced SendToBulk), or one unary SendToOnce each through
`deliver_egress`. An optional pcap tap (`capture`, utils/pcap.py)
records "in" at ingestion and "out" at pod-side delivery.

WhatIf serves a what-if sweep (kubedtn_tpu_torch.twin), tenant-scoped
when the request names a tenant of the attached registry, PlanUpdate and
ApplyPlan the planned-update surface (kubedtn_tpu_torch.updates), and
the Tenant* RPCs the tenancy registry (kubedtn_tpu_torch.tenancy) that
`WireDataPlane.attach_tenancy` installs as `tenancy`.

`drain_ingress` takes the registry's per-wire admission budget
(`admit`), and with a shm.ShmIngest attached as `shm` it folds the
shared-memory rings' committed frames into the same batches and backlog,
one batch per wire: a ring drained in several spans (a producer's commit
landing between two dequeues), or a wire fed over gRPC and a ring in one
tick, is merged into the wire's one batch. The JAX package hands the
plane a batch per span, so a row can appear twice in one shaping group:
shaped twice from the same state, counted once (a fault pinned in
tests/test_torch_shm.py).

`FrameSeg.materialize` slices a segment's frames in one C loop
(`slice_frames` of native/kdt_ext.c, built by kubedtn_tpu_torch.native)
and keeps the pure-Python path where the Python headers do not resolve.

ObserveSLO serves the SLO evaluator (kubedtn_tpu_torch.slo) that its
`attach` installs as `slo`, created on first use where the daemon has a
tenancy registry and a plane with telemetry; AutopilotCtl and
AutopilotStatus serve the autopilot (kubedtn_tpu_torch.autopilot)
installed as `autopilot`. MigrateTenant and MigrationStatus serve the
federation's migration controller (kubedtn_tpu_torch.federation) that
its `register` installs as `federation`; ObserveSLO then names the
plane and appends the frozen slices of tenants this plane migrated
away. FleetStatus and FleetUpgrade serve the fleet supervisor
(kubedtn_tpu_torch.federation.supervisor) that its `attach` installs as
`fleet`; ObserveSLO(fleet=true) then serves its cross-plane merge, and
Health with a named `plane` answers for another plane of the federation.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field

from kubedtn_tpu_torch.topology.engine import SimEngine, uid_from_vni
from kubedtn_tpu_torch.topology.store import NotFoundError

DEFAULT_PORT = 51111  # reference common/constants.go:9


def _abort(context, code_name: str, msg: str):
    """context.abort with a grpc.StatusCode named by `code_name` (grpc
    imported only here, on the RPC path)."""
    import grpc

    context.abort(getattr(grpc.StatusCode, code_name), msg)


def _pb():
    from kubedtn_tpu_torch.wire import proto

    return proto


class FrameSeg:
    """Zero-copy window of frames inside ONE serialized PacketBatch blob.

    The coalesced bulk transport's ingress representation (round 5): the
    native walker yields flat (offsets, lens) arrays over the raw gRPC
    message bytes, and the frames stay INSIDE the blob — one deque entry
    and one refcount for a whole 256-frame batch, pointer arithmetic for
    the native bypass/classify call, numpy views for the shaping sizes.
    Frames only become individual bytes objects where delivery (or a
    checkpoint/bypass path) actually needs them. `lo:hi` is the
    live window, so the seq-slots cap and drain budgets split a segment
    by advancing indices, never by copying payload. offsets/lens are
    parallel uint64 arrays and need not be contiguous or sorted (a
    multi-wire batch's per-wire groups share the arrays re-ordered)."""

    __slots__ = ("blob", "offs", "lens", "lo", "hi", "_base", "traces")

    def __init__(self, blob, offs, lens, lo: int = 0,
                 hi: int | None = None) -> None:
        self.blob = blob
        self.offs = offs
        self.lens = lens
        self.lo = lo
        self.hi = len(offs) if hi is None else hi
        self._base = None
        # carried trace ids (shm ingest: sampled producer ids ride the
        # slot layout into the plane): [(index into offs/lens, tid)],
        # indices absolute like lo/hi. None = nothing carried.
        self.traces = None

    def __len__(self) -> int:
        return self.hi - self.lo

    def base_addr(self) -> int:
        """Address of the blob's first byte (frames live at base+offs).
        The returned pointers are only valid while this segment (which
        holds the blob reference) is alive."""
        if self._base is None:
            import numpy as np

            self._base = np.frombuffer(self.blob, np.uint8).ctypes.data
        return self._base

    def ptrs(self):
        """uint64[len(self)] frame pointers for the native batch call."""
        return self.base_addr() + self.offs[self.lo:self.hi]

    def win_lens(self):
        """uint64[len(self)] frame lengths for the live window."""
        return self.lens[self.lo:self.hi]

    def split(self, k: int) -> "FrameSeg":
        """Detach and return the first k frames as a new segment;
        self advances past them."""
        head = FrameSeg(self.blob, self.offs, self.lens, self.lo,
                        self.lo + k)
        if self.traces is not None:
            cut = self.lo + k
            head.traces = [e for e in self.traces if e[0] < cut] or None
            self.traces = [e for e in self.traces if e[0] >= cut] or None
        self.lo += k
        return head

    def materialize(self) -> list[bytes]:
        """The window's frames as individual bytes objects (delivery,
        checkpoint, bypass). One C loop when the kdt_ext extension is
        loaded — materialization is the live plane's dominant
        release-stage cost once ingress is zero-copy."""
        from kubedtn_tpu_torch import native

        ext = native.kdt_ext()
        if ext is not None:
            return ext.slice_frames(self.blob, self.offs, self.lens,
                                    self.lo, self.hi)
        b = self.blob
        return [b[o:o + ln] for o, ln in
                zip(self.offs[self.lo:self.hi].tolist(),
                    self.lens[self.lo:self.hi].tolist())]


def _entry_frames(item) -> int:
    """Frame count of one ingress-deque entry (segment or single frame)."""
    return len(item) if type(item) is FrameSeg else 1


def one_batch_per_wire(batches: list) -> list:
    """Drain batches (wire, row, lens, parts) with every wire's entries
    merged into its first, in arrival order: lens concatenated, parts
    appended. The plane shapes each batch as one row of a group, so a
    wire must not appear twice."""
    import numpy as np

    first: dict[int, int] = {}
    out: list = []
    for b in batches:
        i = first.get(b[0].wire_id)
        if i is None:
            first[b[0].wire_id] = len(out)
            out.append(b)
            continue
        wire, row, lens, parts = out[i]
        out[i] = (wire, row,
                  np.concatenate([np.asarray(lens, np.uint64),
                                  np.asarray(b[2], np.uint64)]),
                  [*parts, *b[3]])
    return out


def flatten_frames(parts) -> list[bytes]:
    """Materialize a mixed parts list (bytes | FrameSeg) into per-frame
    bytes objects, in order."""
    out: list[bytes] = []
    for p in parts:
        if type(p) is FrameSeg:
            out.extend(p.materialize())
        else:
            out.append(p)
    return out


class _NotifyingDeque(deque):
    """deque that fires a callback on any enqueue — direct `wire.ingress
    .append(...)` (tests, embedders) marks the wire hot exactly like the
    RPC ingestion paths do. The registry (WireManager) installs the
    callback on every wire it learns about, whatever constructed it.

    len() reports FRAMES, not entries: a FrameSeg entry counts as its
    window size, so backpressure high-water checks, backlog metrics and
    tests keep frame semantics whatever the queue's representation. The
    count is maintained exactly under a small lock (enqueues come from
    many gRPC workers, the drain pops from the plane thread). Entries
    still iterate as stored — consumers must treat a FrameSeg entry as
    len(seg) frames (drain_ingress does)."""

    def __init__(self, notify=None) -> None:
        super().__init__()
        self._notify = notify
        self._flock = threading.Lock()
        self._frames = 0

    def _fire(self) -> None:
        if self._notify is not None:
            self._notify()

    def __len__(self) -> int:
        return self._frames

    def __bool__(self) -> bool:
        return self._frames > 0

    def entries(self) -> int:
        """Underlying entry count (deque length)."""
        return deque.__len__(self)

    def snapshot_entries(self) -> list:
        """Consistent copy of the queued entries (producers may be
        appending concurrently — plain iteration can raise). The
        checkpoint capture reads ingress through this."""
        with self._flock:
            return list(self)

    def append(self, item) -> None:  # noqa: A003
        with self._flock:
            super().append(item)
            self._frames += _entry_frames(item)
        self._fire()

    def appendleft(self, item) -> None:
        with self._flock:
            super().appendleft(item)
            self._frames += _entry_frames(item)
        self._fire()

    def extend(self, items) -> None:
        items = list(items)
        with self._flock:
            super().extend(items)
            self._frames += sum(_entry_frames(i) for i in items)
        self._fire()

    def extendleft(self, items) -> None:
        items = list(items)
        with self._flock:
            super().extendleft(items)
            self._frames += sum(_entry_frames(i) for i in items)
        self._fire()

    def insert(self, index, item) -> None:
        with self._flock:
            super().insert(index, item)
            self._frames += _entry_frames(item)
        self._fire()

    def popleft(self):
        with self._flock:
            item = super().popleft()
            self._frames -= _entry_frames(item)
            return item

    def pop(self):  # noqa: A003
        with self._flock:
            item = super().pop()
            self._frames -= _entry_frames(item)
            return item

    def remove(self, value) -> None:
        with self._flock:
            super().remove(value)
            self._frames -= _entry_frames(value)

    def clear(self) -> None:
        with self._flock:
            super().clear()
            self._frames = 0

    def __iadd__(self, items):
        # deque's C-level __iadd__ would bypass the extend override
        self.extend(items)
        return self


@dataclass
class Wire:
    """One attachment of an external endpoint to a simulated link end."""

    wire_id: int
    uid: int
    pod_key: str
    node_iface_name: str
    peer_intf_id: int = 0
    peer_ip: str = ""
    ingress: deque = field(default_factory=_NotifyingDeque)  # awaiting sim
    egress: deque = field(default_factory=deque)   # frames the sim delivered


class WireManager:
    """Registry of wires, indexed like the reference's wireMap
    (grpcwire.go:100-158): by (netns, uid) for lookups and by interface id
    for O(1) per-packet dispatch."""

    def __init__(self, on_ingress=None) -> None:
        self._lock = threading.Lock()
        self._next_index = 0
        self._next_wire_id = 1000
        self._by_id: dict[int, Wire] = {}
        self._by_key: dict[tuple[str, int], Wire] = {}
        # namespace → wire keys, maintained incrementally: the
        # federation fork/release paths slice one tenant's wires out
        # of the registry, and a full `all()` walk inside a staging
        # barrier is O(all wires) host work the dtnscale layer budgets
        # out (tenant-scoped steps must be O(tenant rows))
        self._by_ns: dict[str, set[tuple[str, int]]] = {}
        # called with the wire whenever frames are queued on its ingress
        # (the daemon wires this to its hot set); installed on EVERY
        # registered wire regardless of who constructed it
        self._on_ingress = on_ingress

    def _install_notify(self, wire: Wire) -> None:
        if self._on_ingress is None:
            return
        if not isinstance(wire.ingress, _NotifyingDeque):
            # exotic embedder replaced the default _NotifyingDeque with a
            # plain one: swap it out, preserving what's queued. Producers
            # must not enqueue CONCURRENTLY with registration on a plain
            # deque (no chase loop can close that race); use the default
            # factory, or re-read wire.ingress after registering.
            nd = _NotifyingDeque()
            nd.extend(wire.ingress)
            wire.ingress = nd
        wire.ingress._notify = lambda: self._on_ingress(wire)
        if wire.ingress:  # frames queued before registration
            self._on_ingress(wire)

    def gen_node_iface_name(self, pod_name: str, pod_intf: str) -> str:
        """Unique per-node interface name, reference format
        "%.5s%.5s-%04d" (grpcwire.go:270-288)."""
        with self._lock:
            self._next_index += 1
            return f"{pod_name[:5]}{pod_intf[:5]}-{self._next_index:04d}"

    def _index_ns(self, wire: Wire) -> None:
        ns = wire.pod_key.partition("/")[0]
        self._by_ns.setdefault(ns, set()).add((wire.pod_key, wire.uid))

    def _unindex_ns(self, pod_key: str, uid: int) -> None:
        keys = self._by_ns.get(pod_key.partition("/")[0])
        if keys is not None:
            keys.discard((pod_key, uid))

    def add(self, wire: Wire) -> None:
        with self._lock:
            self._by_id[wire.wire_id] = wire
            self._by_key[(wire.pod_key, wire.uid)] = wire
            self._index_ns(wire)
            self._install_notify(wire)

    def get_or_create(self, pod_key: str, uid: int, build) -> tuple:
        """Atomic wire-exists guard: two racing creates for the same
        (pod, uid) yield ONE wire — the reference de-duplicates racing
        CreateGRPCWire calls via the wire-exists/IsReady check under its
        map lock (reference daemon/grpcwire/grpcwire.go:292-383).
        `build(wire_id)` constructs the wire only when absent. Returns
        (wire, created)."""
        with self._lock:
            wire = self._by_key.get((pod_key, uid))
            if wire is not None:
                return wire, False
            self._next_wire_id += 1
            wire = build(self._next_wire_id)
            self._by_id[wire.wire_id] = wire
            self._by_key[(wire.pod_key, wire.uid)] = wire
            self._index_ns(wire)
            self._install_notify(wire)
            return wire, True

    def get_by_id(self, wire_id: int) -> Wire | None:
        return self._by_id.get(wire_id)

    def get_by_key(self, pod_key: str, uid: int) -> Wire | None:
        return self._by_key.get((pod_key, uid))

    def delete_by_key(self, pod_key: str, uid: int) -> bool:
        """Remove ONE wire by its (pod, uid) identity — the federation
        undo path deletes exactly the wires a migration restore
        created, never a neighbor wire that happens to share the
        namespace."""
        with self._lock:
            wire = self._by_key.pop((pod_key, uid), None)
            if wire is None:
                return False
            self._by_id.pop(wire.wire_id, None)
            self._unindex_ns(pod_key, uid)
            return True

    def delete_by_pod(self, pod_key: str) -> int:
        with self._lock:
            doomed = [w for w in self._by_id.values()
                      if w.pod_key == pod_key]
            for w in doomed:
                self._by_id.pop(w.wire_id, None)
                self._by_key.pop((w.pod_key, w.uid), None)
                self._unindex_ns(w.pod_key, w.uid)
            return len(doomed)

    def all(self) -> list[Wire]:
        return list(self._by_id.values())

    def in_namespaces(self, spaces) -> list[Wire]:
        """Wires whose pod lives in one of `spaces`, via the namespace
        index — O(matching wires), in wire-id (creation) order like a
        filtered `all()` walk. The federation fork barrier slices one
        tenant's wires with this instead of filtering `all()` (O(all
        wires) inside a tick-lock barrier)."""
        with self._lock:
            keys = [k for ns in spaces for k in self._by_ns.get(ns, ())]
            out = [w for w in (self._by_key.get(k) for k in keys)
                   if w is not None]
            out.sort(key=lambda w: w.wire_id)
            return out


class Daemon:
    """Service implementations bound to one engine."""

    def __init__(self, engine: SimEngine, latency_histograms=None,
                 forward_timeout_s: float = 0.5) -> None:
        self.engine = engine
        # wires with queued ingress — the data plane drains only these,
        # so a tick is O(active wires), not O(all wires); the registry
        # installs the marking hook on every wire it learns about
        self._hot_lock = threading.Lock()
        self._hot: set[int] = set()
        # optional wake-up for the data plane: set by WireDataPlane so
        # ingress arriving mid-sleep starts a tick immediately instead of
        # waiting out the period
        self.ingress_signal: threading.Event | None = None
        # back-reference installed by WireDataPlane: the Observe* and
        # Health surfaces read the live plane through it
        self.dataplane = None
        self.wires = WireManager(on_ingress=self.mark_hot)
        self.hist = latency_histograms
        # deadline on per-frame peer forwards: a blackholed peer must cost
        # at most this long, never stall the data plane indefinitely
        self.forward_timeout_s = forward_timeout_s
        # Per-protocol ingress counters via the native frame classifier —
        # the per-packet role of the reference's DecodeFrame debug logging
        # (grpcwire.go:429-450), kept as cheap counters instead of strings.
        self.frame_stats: Counter[str] = Counter()
        # daemon->daemon wire forwarding (the reference's per-frame
        # SendToOnce to the peer daemon, grpcwire.go:452-459): send
        # errors counted, not fatal. Incremented from the tick thread
        # AND the per-peer sender threads — use count_forward_errors.
        self.forward_errors = 0
        self._err_lock = threading.Lock()
        self._bp_slots = threading.BoundedSemaphore(
            self._BP_MAX_SLEEPERS)
        # bulk-transport frames whose remot_intf_id resolved to no wire:
        # dropped (the per-frame SendToOnce aborts NOT_FOUND instead, but
        # a stream can't abort per-message without killing the batch), so
        # a mis-plumbed sender shows up HERE instead of as unexplained loss
        self.bulk_unresolved = 0
        # peers assumed to speak the coalesced SendToBulk extension until
        # one answers UNIMPLEMENTED (a reference-built Go daemon); the
        # egress sender then falls back to per-frame SendToStream for
        # that peer UNTIL its circuit breaker's next half-open probe
        # calls reset_peer_bulk — an upgraded/restarted peer regains the
        # bulk path instead of being latched stream-only forever
        self.peer_bulk_ok: dict[str, bool] = {}
        # ingress-deque entries the last drain_ingress left queued but
        # COULD drain next call (budget residue only — unrealized wires
        # wait on the control plane and holdback-skipped wires on the
        # plane's own buffer, so neither belongs in a signal that makes
        # the runner shed its sleep or grow its batch). Entry-
        # denominated like INGRESS_HIGH_WATER (a bulk FrameSeg entry
        # holds up to ~256 frames), which keeps the gauge O(1) per wire.
        self.last_drain_backlog = 0
        # optional pcap tap (utils/pcap.CaptureManager) — the
        # observability stand-in for the reference's per-wire libpcap
        # handles (grpcwire.go:398-409); None = zero cost
        self.capture = None
        # optional flight recorder (telemetry.FlightRecorder) — set by
        # WireDataPlane.enable_telemetry on the sending side, or
        # directly on a receive-only daemon: frames arriving with a
        # nonzero Packet.trace_id attach their `received` event here,
        # closing the cross-node half of a sampled trace. None = zero
        # cost on every ingestion path.
        self.recorder = None
        # tenancy.TenantRegistry installed by attach_tenancy: the
        # Local.Tenant* RPCs answer from it (without one they answer
        # ok=False "tenancy not enabled")
        self.tenancy = None
        # the federation's controller (set by its register()) and fleet
        # supervisor: MigrateTenant / MigrationStatus and ObserveSLO's
        # plane name and frozen windows read the controller, its fleet
        # merge, FleetStatus and FleetUpgrade the supervisor
        self.federation = None
        self.fleet = None
        # slo.SloEvaluator installed by its attach(): the
        # Local.ObserveSLO surface (absent = the RPC answers ok=False
        # "slo evaluation not enabled")
        self.slo = None
        # autopilot.Autopilot installed by its attach(): the
        # Local.AutopilotCtl / Local.AutopilotStatus surface (absent =
        # the RPCs answer ok=False "autopilot not attached")
        self.autopilot = None
        # optional shm.ShmIngest — the shared-memory ingest plane:
        # drain_ingress folds its rings' committed frames into each
        # drain (None = gRPC ingress only)
        self.shm = None

    def count_forward_errors(self, n: int) -> None:
        """Thread-safe forward_errors increment (CPython += is not
        atomic; per-peer sender threads race each other and the tick)."""
        with self._err_lock:
            self.forward_errors += n

    def reset_peer_bulk(self, addr: str) -> None:
        """Forget a peer's stream-only latch (called at every breaker
        half-open probe, and safe on channel reconnect): the next send
        re-tries the coalesced SendToBulk transport, so a peer upgraded
        from a reference-built daemon regains the bulk path."""
        self.peer_bulk_ok.pop(addr, None)

    def count_bulk_unresolved(self, n: int) -> None:
        """Thread-safe bulk_unresolved increment (concurrent bulk
        streams run on the server's worker pool)."""
        with self._err_lock:
            self.bulk_unresolved += n

    def _peer_wire_client(self, addr: str):
        # one per-address client cache per node, shared with the engine's
        # Remote.Update dialing (same channel carries both RPC kinds)
        return self.engine._peer_daemon(addr)

    # -- Local ---------------------------------------------------------

    def Get(self, request, context):
        try:
            topo = self.engine.get_pod(request.name, request.kube_ns)
        except NotFoundError:
            _abort(context, "NOT_FOUND", f"pod {request.name} not found")
        pb = _pb()
        return pb.Pod(
            name=topo.name,
            src_ip=topo.status.src_ip,
            net_ns=topo.status.net_ns,
            kube_ns=topo.namespace,
            links=[pb.link_to_proto(l) for l in topo.spec.links],
        )

    def SetAlive(self, request, context):
        ok = self.engine.set_alive(request.name, request.kube_ns or "default",
                                   request.src_ip, request.net_ns)
        return _pb().BoolResponse(response=ok)

    def _batch(self, request, fn):
        pb = _pb()
        try:
            topo = self.engine.get_pod(request.local_pod.name,
                                       request.local_pod.kube_ns)
        except NotFoundError:
            return pb.BoolResponse(response=False)
        links = [pb.link_from_proto(l) for l in request.links]
        return pb.BoolResponse(response=fn(topo, links))

    def AddLinks(self, request, context):
        return self._batch(request, self.engine.add_links)

    def DelLinks(self, request, context):
        return self._batch(request, self.engine.del_links)

    def UpdateLinks(self, request, context):
        return self._batch(request, self.engine.update_links)

    def SetupPod(self, request, context):
        ok = self.engine.setup_pod(request.name, request.kube_ns or "default",
                                   request.net_ns)
        return _pb().BoolResponse(response=ok)

    def DestroyPod(self, request, context):
        pod_key = f"{request.kube_ns or 'default'}/{request.name}"
        self.wires.delete_by_pod(pod_key)
        ok = self.engine.destroy_pod(request.name,
                                     request.kube_ns or "default")
        return _pb().BoolResponse(response=ok)

    def GRPCWireExists(self, request, context):
        pod_key = f"{request.kube_ns or 'default'}/{request.local_pod_name}"
        wire = self.wires.get_by_key(pod_key, int(request.link_uid))
        pb = _pb()
        if wire is None:
            return pb.WireCreateResponse(response=False,
                                         peer_intf_id=request.peer_intf_id)
        return pb.WireCreateResponse(response=True,
                                     peer_intf_id=wire.peer_intf_id)

    def AddGRPCWireLocal(self, request, context):
        self._add_wire(request)
        return _pb().BoolResponse(response=True)

    def RemGRPCWire(self, request, context):
        pod_key = f"{request.kube_ns or 'default'}/{request.local_pod_name}"
        self.wires.delete_by_pod(pod_key)
        return _pb().BoolResponse(response=True)

    def GenerateNodeInterfaceName(self, request, context):
        name = self.wires.gen_node_iface_name(request.pod_name,
                                              request.pod_intf_name)
        return _pb().GenerateNodeInterfaceNameResponse(ok=True,
                                                    node_intf_name=name)

    def ObserveLinks(self, request, context):
        """Framework extension: ranked per-edge window-ring stats from
        the link telemetry plane (`cli top` reads this)."""
        pb = _pb()
        plane = self.dataplane
        tel = getattr(plane, "telemetry", None) if plane else None
        if tel is None:
            return pb.ObserveLinksResponse(
                ok=False, error="link telemetry not enabled on this "
                                "daemon (start with telemetry on)")
        windows = int(request.windows) or None
        try:
            rows, secs, truncated = tel.link_rows(self.engine,
                                                  last=windows)
        except Exception as e:  # a query must never kill the daemon
            return pb.ObserveLinksResponse(
                ok=False, error=f"{type(e).__name__}: {e}")
        top = int(request.top_n) or len(rows)
        nn = lambda v: -1.0 if v is None else float(v)  # noqa: E731
        return pb.ObserveLinksResponse(
            ok=True, covered_seconds=secs, truncated=truncated,
            windows_closed=tel.windows_closed,
            links=[pb.LinkStats(
                pod=r["pod"], namespace=r["namespace"], uid=r["uid"],
                row=r["row"], tx=r["tx"], delivered=r["delivered"],
                delivered_pps=r["delivered_pps"],
                bytes_ps=r["bytes_ps"],
                dropped_loss=r["dropped_loss"],
                dropped_queue=r["dropped_queue"],
                corrupted=r["corrupted"], queue_depth=r["queue_depth"],
                mean_lat_us=nn(r["mean_lat_us"]),
                p50_us=nn(r["p50_us"]), p99_us=nn(r["p99_us"]),
                p99_censored=bool(r.get("p99_censored", False)),
            ) for r in rows[:top]])

    def ObservePauses(self, request, context):
        """Framework extension: barrier-pause attribution from the
        data plane's PauseLedger (kubedtn_tpu_torch.pauses) — per-cause
        pause aggregates, tick-latency-by-cause histograms and the
        most recent attributed events (`kdt pauses` reads this)."""
        pb = _pb()
        plane = self.dataplane
        ledger = getattr(plane, "pauses", None) if plane else None
        if ledger is None:
            return pb.ObservePausesResponse(
                ok=False, error="no data plane (pause ledger) attached "
                                "to this daemon")
        try:
            snap = ledger.snapshot()
            want = request.cause
            hist = snap["tick_hist"]
            causes = []
            total = 0.0
            for c in sorted(snap["causes"]):
                a = snap["causes"][c]
                total += a["seconds"]
                if want and c != want:
                    continue
                h = hist.get(c) or {}
                causes.append(pb.PauseCauseStat(
                    cause=c, count=a["count"], seconds=a["seconds"],
                    max_s=a["max_s"], last_s=a["last_s"],
                    last_t_s=a["last_t_s"], rows=a["rows"],
                    bytes=a["bytes"],
                    tick_buckets=[int(b) for b in
                                  h.get("buckets") or ()],
                    tick_count=int(h.get("count", 0)),
                    tick_sum_s=float(h.get("sum_s", 0.0))))
            # clean-tick histogram rides as the pseudo-cause "none"
            # (count 0 on the aggregate side, by construction)
            if not want and "none" in hist:
                h = hist["none"]
                causes.append(pb.PauseCauseStat(
                    cause="none",
                    tick_buckets=[int(b) for b in h["buckets"]],
                    tick_count=int(h["count"]),
                    tick_sum_s=float(h["sum_s"])))
            n_ev = int(request.events)
            events = []
            if n_ev > 0:
                for ev in ledger.events(n_ev):
                    if want and ev.get("cause") != want:
                        continue
                    detail = " ".join(
                        f"{k}={v}" for k, v in sorted(ev.items())
                        if k not in ("cause", "dur_s", "t_s"))
                    events.append(pb.PauseEvent(
                        cause=ev.get("cause", ""),
                        dur_s=float(ev.get("dur_s", 0.0)),
                        t_s=float(ev.get("t_s", 0.0)),
                        detail=detail))
        except Exception as e:  # a query must never kill the daemon
            return pb.ObservePausesResponse(
                ok=False, error=f"{type(e).__name__}: {e}")
        return pb.ObservePausesResponse(
            ok=True, enabled=snap["enabled"],
            uptime_s=snap["uptime_s"], total_pause_s=total,
            causes=causes, events=events,
            dropped_events=snap["dropped_events"],
            tick_edges_s=[float(e) for e in snap["tick_edges_s"]])

    def ObserveTrace(self, request, context):
        """Framework extension: flight-recorder event export — one
        trace's path (trace_id != 0) or the newest events (`cli trace`
        merges several daemons' answers into a hop-by-hop view)."""
        pb = _pb()
        rec = self.recorder
        if rec is None:
            return pb.ObserveTraceResponse(
                ok=False, error="flight recorder not enabled on this "
                                "daemon")
        limit = int(request.limit) or 1000
        evs = rec.export(trace_id=int(request.trace_id), limit=limit)
        return pb.ObserveTraceResponse(
            ok=True, sampled=rec.sampled,
            recent_traces=rec.recent_traces(limit=50),
            events=[pb.TraceEvent(
                trace_id=e["trace_id"], t=e["t"], node=e["node"],
                stage=e["stage"],
                detail=" ".join(f"{k}={v}" for k, v in
                                sorted(e["detail"].items())),
            ) for e in evs])

    def health_snapshot(self) -> dict:
        """The full Local.Health payload for THIS daemon's plane: the
        plane-local supervision gauges (runtime.WireDataPlane.health)
        plus engine capacity headroom and tenant count. Every read is a
        torn-read-tolerant gauge — the probe must answer even while a
        wedged dispatch holds the tick lock (that wedge is precisely
        what the caller is trying to detect)."""
        plane = self.dataplane
        if plane is not None:
            h = plane.health()
        else:  # control-plane-only daemon: serving, but no runner
            h = {"running": False, "heartbeat_age_s": None,
                 "watchdog_stalls": 0, "watchdog_stalled": False,
                 "degrade_level": 0, "tick_errors": 0, "ticks": 0,
                 "backlog": 0, "holdback_wires": 0, "inflight": 0,
                 "pipeline_depth": 0, "effective_depth": 0,
                 "serving": True}
        engine = self.engine
        # int shape read, torn-read tolerant: the probe must not block
        # behind the engine lock
        cap = int(engine._state.capacity)
        active = int(engine.num_active)
        h["node"] = engine.node_ip
        h["capacity"] = cap
        h["active_rows"] = active
        h["headroom_rows"] = max(0, cap - active)
        reg = self.tenancy
        h["tenants"] = len(reg.list()) if reg is not None else 0
        return h

    @staticmethod
    def _health_response(h: dict, ok: bool = True,
                         error: str = ""):
        hb = h.get("heartbeat_age_s")
        return _pb().HealthResponse(
            ok=ok, error=error, node=h.get("node", ""),
            running=bool(h.get("running", False)),
            serving=bool(h.get("serving", False)),
            heartbeat_age_s=-1.0 if hb is None else float(hb),
            watchdog_stalls=int(h.get("watchdog_stalls", 0)),
            watchdog_stalled=bool(h.get("watchdog_stalled", False)),
            degrade_level=int(h.get("degrade_level", 0)),
            tick_errors=int(h.get("tick_errors", 0)),
            ticks=int(h.get("ticks", 0)),
            backlog=int(h.get("backlog", 0)),
            holdback_wires=int(h.get("holdback_wires", 0)),
            inflight=int(h.get("inflight", 0)),
            pipeline_depth=int(h.get("pipeline_depth", 0)),
            effective_depth=int(h.get("effective_depth", 0)),
            tenants=int(h.get("tenants", 0)),
            capacity=int(h.get("capacity", 0)),
            active_rows=int(h.get("active_rows", 0)),
            headroom_rows=int(h.get("headroom_rows", 0)))

    def Health(self, request, context):
        """Framework extension: the rich plane-health surface the fleet
        supervisor's suspicion machine probes — heartbeat age, watchdog
        stalls, degradation rung, tick errors, backlog, tenant count
        and capacity headroom in one RPC (until now only the Prometheus
        endpoint carried these). `plane` names another plane registered
        with this daemon's federation controller; empty = this one."""
        name = request.plane
        if name and self.federation is not None:
            from kubedtn_tpu_torch.federation import MigrationError

            try:
                handle = self.federation.handle(name)
            except MigrationError as e:
                return _pb().HealthResponse(ok=False, error=str(e))
            return self._health_response(handle.daemon.health_snapshot())
        return self._health_response(self.health_snapshot())

    def FleetStatus(self, request, context):
        """Framework extension: the fleet supervisor's view — per-plane
        suspicion state + health, and the placement ledger."""
        pb = _pb()
        sup = self.fleet
        if sup is None:
            return pb.FleetStatusResponse(
                ok=False, error="fleet supervision not enabled on this "
                                "daemon")
        st = sup.status()
        return pb.FleetStatusResponse(
            ok=True,
            planes=[pb.PlaneStatus(
                name=p["name"], state=p["state"],
                consecutive_failures=int(p["consecutive_failures"]),
                last_error=p.get("last_error") or "",
                tenants_placed=int(p["tenants_placed"]),
                health=self._health_response(p["health"])
                if p.get("health") else pb.HealthResponse(ok=False),
            ) for p in st["planes"]],
            placements=[pb.PlacementEntry(tenant=t, plane=pl)
                        for t, pl in sorted(st["placements"].items())],
            sweeps=int(st["sweeps"]),
            evacuations=int(st["evacuations"]))

    def FleetUpgrade(self, request, context):
        """Framework extension: rolling upgrade across the supervisor's
        planes — cordon, drain via live migration, restart the daemon,
        health-verify, refill, next plane. Synchronous; the request
        timeout bounds it."""
        pb = _pb()
        sup = self.fleet
        if sup is None:
            return pb.FleetUpgradeResponse(
                ok=False, error="fleet supervision not enabled on this "
                                "daemon")
        from kubedtn_tpu_torch.federation import MigrationError
        from kubedtn_tpu_torch.federation.supervisor import FleetError

        try:
            out = sup.rolling_upgrade(
                planes=list(request.planes) or None,
                verify_probes=int(request.verify_probes) or None)
        except (FleetError, MigrationError) as e:
            return pb.FleetUpgradeResponse(
                ok=False, error=f"{type(e).__name__}: {e}")
        return pb.FleetUpgradeResponse(
            ok=all(r.get("error", "") == "" for r in out["reports"]),
            reports=[pb.UpgradeReport(
                plane=r["plane"],
                drained_tenants=list(r["drained_tenants"]),
                refilled_tenants=list(r["refilled_tenants"]),
                restarted=bool(r["restarted"]),
                healthy=bool(r["healthy"]),
                error=r.get("error", ""),
            ) for r in out["reports"]],
            migrations=int(out["migrations"]),
            frames_lost_known=bool(out["frames_lost_known"]))

    # -- the what-if twin and planned updates --------------------------

    def WhatIf(self, request, context):
        """Framework extension: serve a what-if sweep from a consistent
        fork of the LIVE data plane (kubedtn_tpu_torch.twin) — the
        real-time runner keeps ticking while the replicas run; only the
        snapshot barrier (one pipeline flush and a copy of the edge
        state) briefly holds the tick lock."""
        from kubedtn_tpu_torch.twin.query import serve_whatif

        return serve_whatif(self, request)

    def PlanUpdate(self, request, context):
        """Framework extension: build + twin-verify an ordered update
        schedule for a topology's declared desired links (the CLAIM
        half of the planned-update surface, kubedtn_tpu_torch.updates)."""
        from kubedtn_tpu_torch.updates.service import serve_plan_update

        return serve_plan_update(self, request)

    def ApplyPlan(self, request, context):
        """Framework extension: stage a verified plan through the live
        plane with watch windows and automatic rollback (the APPLY
        half; kubedtn_tpu_torch.updates.stager)."""
        from kubedtn_tpu_torch.updates.service import serve_apply_plan

        return serve_apply_plan(self, request)

    # -- tenancy (kubedtn_tpu_torch.tenancy) ---------------------------

    def _tenant_info(self, t):
        reg = self.tenancy
        links = int(reg.rows_of(t.name).size) if reg is not None else 0
        return _pb().TenantInfo(
            name=t.name, qos=t.qos, namespaces=sorted(t.namespaces),
            frame_budget_per_s=t.frame_budget_per_s,
            byte_budget_per_s=t.byte_budget_per_s,
            block_lo=t.block[0] if t.block else -1,
            block_hi=t.block[1] if t.block else -1,
            links=links)

    @staticmethod
    def _opt_budget(v: float) -> float | None:
        """Wire budget semantics: negative = leave unchanged (None to
        the registry; what the CLI sends for an omitted flag), 0 =
        explicitly unlimited."""
        return None if v < 0 else float(v)

    def TenantCreate(self, request, context):
        """Register (or quota-update, idempotent on name) one tenant:
        QoS class, admission budgets, optional reserved edge block,
        namespace bindings."""
        pb = _pb()
        reg = self.tenancy
        if reg is None:
            return pb.TenantResponse(
                ok=False, error="tenancy not enabled on this daemon")
        try:
            t = reg.create(
                request.name, qos=request.qos or None,
                frame_budget_per_s=self._opt_budget(
                    request.frame_budget_per_s),
                byte_budget_per_s=self._opt_budget(
                    request.byte_budget_per_s),
                block_edges=int(request.block_edges),
                namespaces=list(request.namespaces) or None)
        except (ValueError, KeyError) as e:
            return pb.TenantResponse(ok=False, error=str(e))
        return pb.TenantResponse(ok=True, tenant=self._tenant_info(t))

    def TenantList(self, request, context):
        pb = _pb()
        reg = self.tenancy
        if reg is None:
            return pb.TenantListResponse(
                ok=False, error="tenancy not enabled on this daemon")
        tenants = reg.list()
        if request.name:
            tenants = [t for t in tenants if t.name == request.name]
        return pb.TenantListResponse(
            ok=True, tenants=[self._tenant_info(t) for t in tenants])

    def TenantQuota(self, request, context):
        """Update an existing tenant's QoS class / admission budgets
        (block reservations never move here)."""
        pb = _pb()
        reg = self.tenancy
        if reg is None:
            return pb.TenantResponse(
                ok=False, error="tenancy not enabled on this daemon")
        try:
            t = reg.set_quota(
                request.name, qos=request.qos or None,
                frame_budget_per_s=self._opt_budget(
                    request.frame_budget_per_s),
                byte_budget_per_s=self._opt_budget(
                    request.byte_budget_per_s))
        except KeyError:
            return pb.TenantResponse(
                ok=False, error=f"unknown tenant {request.name!r}")
        except ValueError as e:
            return pb.TenantResponse(ok=False, error=str(e))
        return pb.TenantResponse(ok=True, tenant=self._tenant_info(t))

    def TenantStats(self, request, context):
        """One tenant's full slice: quotas, admission meters, throttle
        meters, cumulative counter slice, telemetry window slice."""
        pb = _pb()
        reg = self.tenancy
        if reg is None:
            return pb.TenantStatsResponse(
                ok=False, error="tenancy not enabled on this daemon")
        try:
            s = reg.stats(self.dataplane, request.name)
        except KeyError:
            return pb.TenantStatsResponse(
                ok=False, error=f"unknown tenant {request.name!r}")
        t = reg.get(request.name)
        win = s.get("window") or {}
        nn = lambda v: -1.0 if v is None else float(v)  # noqa: E731
        return pb.TenantStatsResponse(
            ok=True, tenant=self._tenant_info(t),
            admitted_frames=int(s["admitted_frames"]),
            admitted_bytes=int(s["admitted_bytes"]),
            throttle_events=int(s["throttle_events"]),
            throttled_frame_ticks=int(s["throttled_frame_ticks"]),
            tx_packets=float(s.get("tx_packets", 0.0)),
            delivered_packets=float(s.get("delivered_packets", 0.0)),
            delivered_bytes=float(s.get("delivered_bytes", 0.0)),
            dropped_loss=float(s.get("dropped_loss", 0.0)),
            dropped_queue=float(s.get("dropped_queue", 0.0)),
            dropped_ring=float(s.get("dropped_ring", 0.0)),
            corrupted=float(s.get("corrupted", 0.0)),
            window_seconds=float(win.get("window_seconds", 0.0)),
            delivered_pps=float(win.get("delivered_pps", 0.0)),
            bytes_ps=float(win.get("bytes_ps", 0.0)),
            p50_us=nn(win.get("p50_us")),
            p99_us=nn(win.get("p99_us")))

    def TenantDelete(self, request, context):
        """Deregister a tenant: free its reserved block, unbind its
        namespaces, end admission/QoS enforcement (the tenant's
        realized links are untouched — DestroyPod owns pod lifecycle).
        ok=False on an unknown name."""
        pb = _pb()
        reg = self.tenancy
        if reg is None:
            return pb.TenantResponse(
                ok=False, error="tenancy not enabled on this daemon")
        t = reg.get(request.name)
        if t is None or not reg.delete(request.name):
            return pb.TenantResponse(
                ok=False, error=f"unknown tenant {request.name!r}")
        return pb.TenantResponse(ok=True, tenant=pb.TenantInfo(
            name=t.name, qos=t.qos, namespaces=sorted(t.namespaces)))

    # -- the SLO plane and the autopilot --------------------------------

    @staticmethod
    def _slo_tenant_msg(v: dict, plane: str = ""):
        """One verdict dict (SloVerdict.to_dict / a fleet-merged row /
        a frozen journal slice) as the wire row."""
        pb = _pb()
        nn = lambda x: -1.0 if x is None else float(x)  # noqa: E731
        spec = v.get("spec") or {}
        return pb.SloTenant(
            tenant=v.get("tenant", ""), qos=v.get("qos") or "",
            delivery_ratio_floor=float(
                spec.get("delivery_ratio_floor", 0.0)),
            p99_bound_us=float(spec.get("p99_bound_us", 0.0)),
            p999_bound_us=float(spec.get("p999_bound_us", 0.0)),
            fast_windows=int(spec.get("fast_windows", 0)),
            slow_windows=int(spec.get("slow_windows", 0)),
            warn_burn=float(spec.get("warn_burn", 0.0)),
            page_burn=float(spec.get("page_burn", 0.0)),
            window_seconds=float(v.get("window_seconds", 0.0)),
            tx=float(v.get("tx", 0.0)),
            delivered=float(v.get("delivered", 0.0)),
            delivery_ratio=nn(v.get("delivery_ratio")),
            p50_us=nn(v.get("p50_us")), p99_us=nn(v.get("p99_us")),
            p99_censored=bool(v.get("p99_censored", False)),
            p999_us=nn(v.get("p999_us")),
            tail_method=v.get("tail_method", ""),
            fast_burn=float(v.get("fast_burn", 0.0)),
            slow_burn=float(v.get("slow_burn", 0.0)),
            budget_remaining=float(v.get("budget_remaining", 0.0)),
            throttle_backlog=float(v.get("throttle_backlog", 0.0)),
            attainment_ok=bool(v.get("attainment_ok", False)),
            latency_ok=bool(v.get("latency_ok", False)),
            severity=v.get("severity", ""),
            hist=[float(x) for x in v.get("hist") or ()],
            frozen=bool(v.get("frozen", False)),
            plane=v.get("plane", plane),
            planes=list(v.get("planes") or ()),
            frozen_planes=list(v.get("frozen_planes") or ()),
            frozen_tx=float(v.get("frozen_tx", 0.0)),
            frozen_delivered=float(v.get("frozen_delivered", 0.0)))

    def ObserveSLO(self, request, context):
        """Framework extension: the SLO observability plane
        (kubedtn_tpu_torch.slo) — per-tenant attainment, censored-tail
        estimates, burn rates and error budgets from the continuously-
        evaluated verdicts. With `fleet=true` and a fleet supervisor
        attached, serves the supervisor's cross-plane merge instead.

        A plane that MIGRATED a tenant away also answers with the
        journal's RECONCILE-frozen window slice for it (`frozen=true`
        rows): `kdt slo --fleet` merging several daemons' answers
        stitches pre-move and post-move windows into one continuous
        view without any daemon seeing the other's ring."""
        pb = _pb()
        ev = self.slo
        if ev is None:
            from kubedtn_tpu_torch.slo import evaluator_for

            ev = evaluator_for(self)
        if ev is None:
            return pb.ObserveSLOResponse(
                ok=False, error="slo evaluation not enabled on this "
                                "daemon (needs tenancy + telemetry)")
        plane_name = ""
        if self.federation is not None:
            try:
                plane_name = self.federation.plane_name_of(self)
            except Exception:
                plane_name = ""
        try:
            if request.fleet and self.fleet is not None:
                # serve the supervision sweep's cached merge; recompute
                # only before the first sweep lands
                merged = self.fleet.last_fleet_slo()
                if merged:
                    if request.tenant:
                        merged = {k: v for k, v in merged.items()
                                  if k == request.tenant}
                else:
                    merged = self.fleet.fleet_slo(
                        tenant=request.tenant)
                snap = ev.stats.snapshot()
                tel = getattr(self.dataplane, "telemetry", None)
                return pb.ObserveSLOResponse(
                    ok=True, fleet=True, plane=plane_name,
                    evaluations=snap["evaluations"],
                    windows_closed=tel.windows_closed if tel else 0,
                    tenants=[self._slo_tenant_msg(v)
                             for _t, v in sorted(merged.items())])
            payloads = ev.verdict_payloads(tenant=request.tenant)
            rows = [self._slo_tenant_msg(v, plane=plane_name)
                    for v in payloads]
            if self.federation is not None and plane_name:
                # frozen slices for tenants this plane migrated away
                from kubedtn_tpu_torch.slo.fleet import from_frozen_window

                served = {p["tenant"] for p in payloads}
                for src, ten, win, qos in self.federation \
                        .frozen_windows(tenant=request.tenant,
                                        src=plane_name):
                    if ten in served:
                        continue
                    c = from_frozen_window(src, win, qos=qos)
                    if c is not None:
                        c["tenant"] = ten
                        rows.append(self._slo_tenant_msg(c, plane=src))
        except Exception as e:  # a query must never kill the daemon
            return pb.ObserveSLOResponse(
                ok=False, error=f"{type(e).__name__}: {e}")
        tel = getattr(self.dataplane, "telemetry", None)
        snap = ev.stats.snapshot()
        return pb.ObserveSLOResponse(
            ok=True, plane=plane_name, tenants=rows,
            windows_closed=tel.windows_closed if tel else 0,
            evaluations=snap["evaluations"])

    @staticmethod
    def _autopilot_action_msg(rec: dict):
        return _pb().AutopilotAction(
            id=int(rec.get("id", 0)), t=float(rec.get("t", 0.0)),
            tenant=rec.get("tenant", ""), kind=rec.get("kind", ""),
            candidate=rec.get("candidate", ""),
            verdict=rec.get("verdict", ""),
            reason=rec.get("reason", ""),
            staged=bool(rec.get("staged", False)),
            rejected=bool(rec.get("rejected", False)),
            rolled_back=bool(rec.get("rolled_back", False)),
            dry_run=bool(rec.get("dry_run", False)),
            candidates=int(rec.get("candidates", 0)),
            plans=int(rec.get("plans", 0)),
            baseline_burn=float(rec.get("baseline_burn", 0.0)),
            projected_burn=float(rec.get("projected_burn", 0.0)),
            compile_s=float(rec.get("compile_s", 0.0)),
            run_s=float(rec.get("run_s", 0.0)),
            gate_s=float(rec.get("gate_s", 0.0)),
            stage_s=float(rec.get("stage_s", 0.0)),
            time_to_green_s=float(rec.get("time_to_green_s", 0.0)))

    def AutopilotCtl(self, request, context):
        """Framework extension: the autopilot's switches —
        enable/disable the loop, toggle dry-run (gate-and-record
        without staging). kubedtn_tpu_torch.autopilot."""
        pb = _pb()
        ap = self.autopilot
        if ap is None:
            return pb.AutopilotCtlResponse(
                ok=False, error="autopilot not attached to this daemon")
        try:
            action = request.action or "status"
            if action == "enable":
                ap.enable()
            elif action == "disable":
                ap.disable()
            elif action == "dry-run-on":
                ap.set_dry_run(True)
            elif action == "dry-run-off":
                ap.set_dry_run(False)
            elif action != "status":
                return pb.AutopilotCtlResponse(
                    ok=False, error=f"unknown action {action!r} "
                    f"(enable|disable|dry-run-on|dry-run-off|status)")
            return pb.AutopilotCtlResponse(
                ok=True, enabled=ap.enabled, dry_run=ap.dry_run)
        except Exception as e:
            return pb.AutopilotCtlResponse(
                ok=False, error=f"{type(e).__name__}: {e}")

    def AutopilotStatus(self, request, context):
        """Framework extension: the autopilot's per-tenant state
        machine positions, each tenant's last action, and (with
        `history` > 0) the action ring — the `kdt autopilot` audit
        surface."""
        pb = _pb()
        ap = self.autopilot
        if ap is None:
            return pb.AutopilotStatusResponse(
                ok=False, error="autopilot not attached to this daemon")
        try:
            st = ap.status()
            states = []
            for name, s in st["tenants"].items():
                if request.tenant and name != request.tenant:
                    continue
                msg = pb.AutopilotTenantState(
                    tenant=name, state=s["state"],
                    pages=int(s["pages"]), fails=int(s["fails"]),
                    hold_remaining_s=float(s["hold_remaining_s"]))
                if s.get("last_action"):
                    msg.last_action.CopyFrom(
                        self._autopilot_action_msg(s["last_action"]))
                states.append(msg)
            actions = []
            if request.history:
                actions = [self._autopilot_action_msg(r)
                           for r in ap.history(
                               tenant=request.tenant,
                               limit=int(request.history))]
            snap = st["stats"]
            return pb.AutopilotStatusResponse(
                ok=True, enabled=st["enabled"],
                dry_run=st["dry_run"], running=st["running"],
                states=states, actions=actions,
                pages_seen=int(snap["pages_seen"]),
                searches_run=int(snap["searches_run"]),
                deltas_staged=int(snap["deltas_staged"]),
                deltas_rejected=int(snap["deltas_rejected"]),
                deltas_rolled_back=int(snap["deltas_rolled_back"]),
                escalations=int(snap["escalations"]))
        except Exception as e:
            return pb.AutopilotStatusResponse(
                ok=False, error=f"{type(e).__name__}: {e}")

    # -- federation (kubedtn_tpu_torch.federation) ---------------------

    @staticmethod
    def _migration_info(rec: dict):
        rc = rec.get("reconcile") or {}
        return _pb().MigrationInfo(
            migration_id=rec.get("migration_id", ""),
            tenant=rec.get("tenant", ""),
            src=rec.get("src", ""), dst=rec.get("dst", ""),
            state=rec.get("state", ""),
            steps_done=list(rec.get("steps_done", ())),
            resumed=int(rec.get("resumed", 0)),
            rollbacks=int(rec.get("rollbacks", 0)),
            transferred_frames=int(
                (rec.get("cutover") or {}).get("transferred_frames",
                                               0)),
            delivered_src_frames=float(
                rc.get("delivered_src_frames", 0.0)),
            delivered_src_bytes=float(
                rc.get("delivered_src_bytes", 0.0)))

    def MigrateTenant(self, request, context):
        """Run (or resume) a live tenant migration between two planes
        registered with this daemon's federation controller. The RPC
        is synchronous — migrations are barrier-scale except for the
        RECONCILE drain, which the request's timeout bounds."""
        pb = _pb()
        fed = self.federation
        if fed is None:
            return pb.MigrateResponse(
                ok=False, error="federation not enabled on this daemon")
        from kubedtn_tpu_torch.chaos import ChaosError
        from kubedtn_tpu_torch.federation import MigrationError
        from kubedtn_tpu_torch.federation.journal import JournalError

        try:
            if request.resume:
                rec = fed.resume(request.migration_id)
            else:
                # empty src defaults to the plane this daemon serves
                src = request.src or fed.plane_name_of(self)
                rec = fed.migrate(
                    request.tenant, src, request.dst,
                    migration_id=request.migration_id or None,
                    reconcile_timeout_s=float(
                        request.reconcile_timeout_s) or 30.0)
        except (MigrationError, JournalError, ChaosError, KeyError,
                ValueError) as e:
            return pb.MigrateResponse(
                ok=False, error=f"{type(e).__name__}: {e}")
        return pb.MigrateResponse(ok=True,
                                  migration=self._migration_info(rec))

    def MigrationStatus(self, request, context):
        pb = _pb()
        fed = self.federation
        if fed is None:
            return pb.MigrationStatusResponse(
                ok=False, error="federation not enabled on this daemon")
        recs = fed.status(migration_id=request.migration_id,
                          tenant=request.tenant)
        return pb.MigrationStatusResponse(
            ok=True,
            migrations=[self._migration_info(r) for r in recs])

    # -- Remote --------------------------------------------------------

    def Update(self, request, context):
        """Peer-daemon link completion (reference handler.go:149-198):
        realize this end of a cross-node link from its VNI."""
        uid = uid_from_vni(request.vni)
        ok = self.engine.remote_update(
            name=request.name, ns=request.kube_ns or "default", uid=uid,
            intf_name=request.intf_name, intf_ip=request.intf_ip,
            peer_vtep=request.peer_vtep,
            props=_pb().props_from_proto(request.properties),
        )
        return _pb().BoolResponse(response=ok)

    def AddGRPCWireRemote(self, request, context):
        wire = self._add_wire(request)
        return _pb().WireCreateResponse(response=True,
                                        peer_intf_id=wire.wire_id)

    def _add_wire(self, wd) -> Wire:
        """Idempotent per (pod, uid): two racing AddGRPCWire calls for the
        same link get the SAME wire (parity with the reference's
        wire-exists guard, grpcwire.go:292-383) — without it, each racer
        would allocate its own wire and the link would split-brain.

        `wd` is a WireDef or any object with its attribute names; a
        `peer_ip` makes it a cross-daemon wire toward that node."""
        pod_key = f"{wd.kube_ns or 'default'}/{wd.local_pod_name}"
        # name generated outside the registry lock (it takes the same
        # lock); an unused name for the loser of the race is harmless
        name = wd.veth_name_local_host or self.wires.gen_node_iface_name(
            wd.local_pod_name, wd.intf_name_in_pod)

        def build(wire_id: int) -> Wire:
            return Wire(
                wire_id=wire_id,
                uid=int(wd.link_uid),
                pod_key=pod_key,
                node_iface_name=name,
                peer_intf_id=int(wd.peer_intf_id),
                peer_ip=wd.peer_ip,
            )

        wire, _ = self.wires.get_or_create(pod_key, int(wd.link_uid), build)
        return wire

    # -- WireProtocol --------------------------------------------------

    def mark_hot(self, wire: Wire) -> None:
        """Note queued ingress on a wire and wake the data plane — the
        entry point for EXTERNAL ingestion."""
        self._remark(wire)
        signal = self.ingress_signal
        if signal is not None:
            signal.set()

    def _remark(self, wire: Wire) -> None:
        """Keep a wire hot for the NEXT scheduled tick without waking the
        runner: used by the drain itself for residue/unrealized retries —
        signaling here would make the wake-early runner busy-spin on a
        wire whose link never realizes."""
        with self._hot_lock:
            self._hot.add(wire.wire_id)

    def _frame_in(self, wire: Wire, frame: bytes) -> None:
        """Reference semantics split by wire kind: a cross-daemon wire
        (peer_ip set) receives frames FROM the peer daemon, already shaped
        on the sender's egress row — they go straight to the pod side
        (egress), like WritePacketData into the pod veth (reference
        handler.go:256-271). A local attachment wire has no daemon peer;
        frames sent to it are pod-origin traffic entering the simulation
        (ingress) — the injection surface standing in for pcap capture."""
        if wire.peer_ip:
            wire.egress.append(frame)
            if self.capture is not None:
                self.capture.record(wire.pod_key, wire.uid, frame, "out")
        else:
            wire.ingress.append(frame)  # the deque's notify marks it hot
            if self.capture is not None:
                self.capture.record(wire.pod_key, wire.uid, frame, "in")

    def _record_received(self, trace_id: int, wire_id: int,
                         delivered: bool) -> None:
        """Attach a cross-node sampled frame's arrival to its trace
        (Packet.trace_id extension): `received` always, and
        `delivered-remote` when the frame landed on the pod-side
        egress queue in the same call."""
        from kubedtn_tpu_torch import telemetry as tele

        rec = self.recorder
        if rec is None:
            return
        rec.record(trace_id, tele.ST_RECEIVED, wire=wire_id)
        if delivered:
            rec.record(trace_id, tele.ST_DELIVERED_REMOTE, wire=wire_id)

    def SendToOnce(self, request, context):
        wire = self.wires.get_by_id(int(request.remot_intf_id))
        if wire is None:
            _abort(context, "NOT_FOUND", f"no wire {request.remot_intf_id}")
        self._frame_in(wire, bytes(request.frame))
        if self.recorder is not None and request.trace_id:
            self._record_received(int(request.trace_id), wire.wire_id,
                                  bool(wire.peer_ip))
        return _pb().BoolResponse(response=True)

    def SendToStream(self, request_iterator, context):
        """Client-streaming frame ingestion — implemented (the reference
        never implements this RPC; kube_dtn.proto:171)."""
        n = 0
        rec = self.recorder
        for pkt in request_iterator:
            wire = self.wires.get_by_id(int(pkt.remot_intf_id))
            if wire is not None:
                self._frame_in(wire, bytes(pkt.frame))
                n += 1
                if rec is not None and pkt.trace_id:
                    self._record_received(int(pkt.trace_id),
                                          wire.wire_id,
                                          bool(wire.peer_ip))
        return _pb().BoolResponse(response=n > 0)

    def InjectFrame(self, request, context):
        """Framework extension (not in the reference proto): pod-origin
        traffic injection for ANY wire, including cross-daemon ones where
        SendToOnce means 'from the peer daemon'. The reference needs no
        such RPC because pcap captures pod frames directly."""
        wire = self.wires.get_by_id(int(request.remot_intf_id))
        if wire is None:
            _abort(context, "NOT_FOUND", f"no wire {request.remot_intf_id}")
        frame = bytes(request.frame)
        wire.ingress.append(frame)
        if self.capture is not None:
            self.capture.record(wire.pod_key, wire.uid, frame, "in")
        return _pb().BoolResponse(response=True)

    # Bulk-ingestion backpressure: when a wire's ingress queue exceeds
    # this many frames, the bulk handlers stall before extending further
    # — gRPC flow control then pushes back on the sender, so a producer
    # that outruns the data plane is paced instead of growing the
    # unbounded deque without limit (the role kernel socket buffers play
    # for the reference's wires). Per-frame RPCs are not gated: they
    # cannot reach rates where this matters.
    INGRESS_HIGH_WATER = 65_536
    # at most this many gRPC workers may sit in a backpressure stall at
    # once: the server pool has 16 workers, and a mesh of stalled bulk
    # streams must never occupy them all and starve control-plane RPCs
    # queued behind them — beyond the cap, producers overshoot the
    # high-water mark by one batch instead of waiting
    _BP_MAX_SLEEPERS = 4

    def _ingress_backpressure(self, wire: Wire) -> None:
        # bounded two ways: a ~2s deadline (a stopped data plane must
        # not wedge a worker) and a sleeper cap (concurrent stalled
        # streams must not exhaust the worker pool)
        if not self._bp_slots.acquire(blocking=False):
            return
        try:
            deadline = time.monotonic() + 2.0
            while (len(wire.ingress) >= self.INGRESS_HIGH_WATER
                   and time.monotonic() < deadline):
                time.sleep(0.002)
        finally:
            self._bp_slots.release()

    def _frames_in_bulk(self, wire: Wire, frames: list[bytes]) -> None:
        """_frame_in for a whole PacketBatch group: ONE deque extend (one
        hot-mark/wake) instead of per-frame appends — the server half of
        the coalesced transport."""
        if wire.peer_ip:
            wire.egress.extend(frames)
            if self.capture is not None:
                for f in frames:
                    self.capture.record(wire.pod_key, wire.uid, f, "out")
        else:
            self._ingress_backpressure(wire)
            wire.ingress.extend(frames)  # single notify marks it hot
            if self.capture is not None:
                for f in frames:
                    self.capture.record(wire.pod_key, wire.uid, f, "in")

    def _bulk_groups(self, item, want_segs: bool = False):
        """Yield (wire_id, frames-list | FrameSeg) groups from one
        bulk-stream message, which arrives either as RAW serialized-
        PacketBatch bytes (the native-decoder fast path registered by
        make_server) or as a parsed PacketBatch (in-process callers,
        no-native builds).

        Raw path: ONE native call yields flat (ids, offsets, lens)
        arrays. With want_segs the group stays a zero-copy FrameSeg
        window over the blob (the data-plane ingress representation);
        otherwise each frame costs a single bytes-slice. The
        all-one-wire case (how the daemons' own egress coalesces) skips
        grouping entirely."""
        if not isinstance(item, (bytes, bytearray, memoryview)):
            groups: dict[int, list[bytes]] = {}
            for pkt in item.packets:
                # pkt.frame is already a bytes object — no copy
                groups.setdefault(pkt.remot_intf_id, []).append(pkt.frame)
                if self.recorder is not None and pkt.trace_id:
                    self._record_received(int(pkt.trace_id),
                                          int(pkt.remot_intf_id), False)
            yield from groups.items()
            return
        from kubedtn_tpu_torch import native as _nat

        blob = bytes(item)
        try:
            # the traced walk decodes Packet.trace_id in the SAME
            # native pass — sampled frames keep their cross-node trace
            # without the zero-copy path ever building message objects
            if self.recorder is not None:
                ids, offs, lens, traces = \
                    _nat.parse_packet_batch_traced(blob)
            else:
                ids, offs, lens = _nat.parse_packet_batch(blob)
                traces = None
        except ValueError:
            # malformed per the native walker: let the protobuf runtime
            # be the arbiter (it raises its own error on true garbage)
            batch = _pb().PacketBatch()
            batch.ParseFromString(blob)
            yield from self._bulk_groups(batch)
            return
        if len(ids) == 0:
            return
        import numpy as np

        if traces is not None and traces.any():
            for k in np.nonzero(traces)[0].tolist():
                self._record_received(int(traces[k]), int(ids[k]),
                                      False)

        offs_u = np.ascontiguousarray(offs, np.uint64)
        lens_u = np.ascontiguousarray(lens, np.uint64)
        if (ids[0] == ids).all():
            if want_segs:
                yield int(ids[0]), FrameSeg(blob, offs_u, lens_u)
            else:
                ends = offs + lens
                yield int(ids[0]), [blob[o:e] for o, e in
                                    zip(offs.tolist(), ends.tolist())]
            return
        order = np.argsort(ids, kind="stable")
        ids_s = ids[order]
        bounds = np.nonzero(np.diff(ids_s))[0] + 1
        starts = [0, *bounds.tolist(), len(ids_s)]
        if want_segs:
            offs_o = np.ascontiguousarray(offs_u[order])
            lens_o = np.ascontiguousarray(lens_u[order])
            for g in range(len(starts) - 1):
                a, b = starts[g], starts[g + 1]
                yield int(ids_s[a]), FrameSeg(blob, offs_o[a:b],
                                              lens_o[a:b])
            return
        offs_s = offs[order].tolist()
        ends_s = (offs + lens)[order].tolist()
        for g in range(len(starts) - 1):
            a, b = starts[g], starts[g + 1]
            yield int(ids_s[a]), [blob[o:e] for o, e in
                                  zip(offs_s[a:b], ends_s[a:b])]

    def SendToBulk(self, request_iterator, context):
        """Framework extension: client-streaming of PacketBatch — the
        daemons' own cross-node egress transport (runtime._flush_remote),
        same delivery semantics as SendToStream frame-by-frame but ~40×
        fewer gRPC messages. Falls outside the reference IDL; peers that
        don't speak it get the per-frame stream instead. Frames bound
        for the data plane stay zero-copy FrameSeg windows when no
        capture needs per-frame bytes."""
        n = 0
        want_segs = self.capture is None
        for item in request_iterator:
            for wid, group in self._bulk_groups(item, want_segs):
                wire = self.wires.get_by_id(wid)
                if wire is not None:
                    if type(group) is FrameSeg:
                        n += len(group)
                        if wire.peer_ip:
                            wire.egress.extend(group.materialize())
                        else:
                            self._ingress_backpressure(wire)
                            wire.ingress.append(group)
                    else:
                        self._frames_in_bulk(wire, group)
                        n += len(group)
                else:
                    self.count_bulk_unresolved(len(group))
        return _pb().BoolResponse(response=n > 0)

    def InjectBulk(self, request_iterator, context):
        """Framework extension: coalesced InjectFrame — pod-origin
        ingress at bulk-transport rates (load generation, tests), on
        every wire kind. One FrameSeg entry per batch-group when no
        capture is active — the ingress cost of a 256-frame batch is one
        deque append."""
        n = 0
        want_segs = self.capture is None
        for item in request_iterator:
            for wid, group in self._bulk_groups(item, want_segs):
                wire = self.wires.get_by_id(wid)
                if wire is None:
                    self.count_bulk_unresolved(len(group))
                    continue
                self._ingress_backpressure(wire)
                if type(group) is FrameSeg:
                    wire.ingress.append(group)
                else:
                    wire.ingress.extend(group)
                    if self.capture is not None:
                        for f in group:
                            self.capture.record(wire.pod_key, wire.uid,
                                                f, "in")
                n += len(group)
        return _pb().BoolResponse(response=n > 0)

    # -- sim ingress/egress bridge ------------------------------------

    def drain_ingress(self, max_per_wire: int = 64, skip=None,
                      admit=None):
        """Collect queued external frames as (wire, row, sizes, frames)
        batches for the next sim step. Only wires marked hot are visited —
        O(wires with traffic), not O(all wires); a wire left with residue
        (more than max_per_wire queued, or no realized row yet) stays hot.
        The row here is advisory: the tick re-resolves every wire's row
        under the engine lock before shaping (compact() may renumber rows
        between this drain and the snapshot). Wire ids in `skip` are left
        untouched but stay hot — the data plane excludes wires whose
        previous drain is still in its holdback buffer.

        `admit` (optional, the tenancy registry's drain policy) maps a
        wire to ITS per-tick budget: a QoS weight scales the default,
        and 0 means the wire's tenant is over its admission budget this
        tick — the wire stays hot with its frames queued (throttled,
        never dropped; the policy records the typed verdict) and, like
        holdback skips, is excluded from the backlog signal.

        `last_drain_backlog` is left holding the entry count this drain
        had to leave behind but could take next call (budget residue
        only — the backpressure input of the plane's adaptive batching
        and sleep-shedding; unrealized-wire, holdback-skipped and
        admission-throttled queues are excluded because ticking harder
        cannot drain them). With `shm` attached, the rings' committed
        spans join the same batch list (admission at the ring head) and
        their residue the same backlog."""
        with self._hot_lock:
            hot, self._hot = self._hot, set()
        out: list = []
        backlog = 0
        for wire_id in hot:
            if skip is not None and wire_id in skip:
                with self._hot_lock:
                    self._hot.add(wire_id)
                continue
            wire = self.wires.get_by_id(wire_id)
            if wire is None:
                continue  # deleted since marked
            wire_budget = max_per_wire
            if admit is not None:
                wire_budget = min(max_per_wire, admit(wire))
                if wire_budget <= 0:
                    if wire.ingress:  # throttled: keep hot, keep frames
                        self._remark(wire)
                    continue
            row = self.engine.row_of(wire.pod_key, wire.uid)
            if row is None:
                if wire.ingress:
                    self._remark(wire)  # retry once the link is realized
                continue
            # single consumer: the frame count can only grow under our
            # feet, so every entry we budget for is safe to pop. Entries
            # are single bytes frames (per-frame RPCs, tests) or
            # FrameSeg windows (bulk transport) — a segment bigger than
            # the remaining budget is SPLIT by index, the residue goes
            # back on the left of the deque (still FIFO, still counted).
            q = wire.ingress
            budget = wire_budget
            parts: list = []
            lens_parts: list = []
            segs = False
            while budget > 0:
                try:
                    e = q.popleft()
                except IndexError:
                    break
                if type(e) is FrameSeg:
                    segs = True
                    n = len(e)
                    if n > budget:
                        head = e.split(budget)
                        q.appendleft(e)  # advanced residue, re-counted
                        e = head
                        n = budget
                    parts.append(e)
                    lens_parts.append(e.win_lens())
                    budget -= n
                else:
                    parts.append(e)
                    lens_parts.append(len(e))
                    budget -= 1
            if q:
                self._remark(wire)  # residue beyond this tick's budget
                backlog += len(q)
            if parts:
                # per-protocol counting happens at the DECIDE stage (the
                # data plane fuses it into the bypass-verdict native
                # call — round 5), not here: the drain must stay cheap
                # and each frame still counts exactly once, on its
                # first decide pass.
                if segs:
                    import numpy as np

                    lens = np.concatenate([
                        p if isinstance(p, np.ndarray)
                        else np.asarray([p], np.uint64)
                        for p in lens_parts])
                else:
                    # legacy all-bytes batch: plain int list + bytes
                    # list, the shape tests and embedders rely on
                    lens = lens_parts
                out.append((wire, row, lens, parts))
        if self.shm is not None:
            # shared-memory ingest: committed ring spans join the same
            # batch list (admission at the ring head BEFORE dequeue),
            # ring residue the same entry-denominated backlog; a wire's
            # spans and its gRPC batch merge into one batch
            n_grpc = len(out)
            backlog += self.shm.drain_into(out, max_per_wire, admit,
                                           self)
            if len(out) > n_grpc:
                out = one_batch_per_wire(out)
        self.last_drain_backlog = backlog
        return out

    def deliver_egress_bulk(self, pod_key: str, uid: int,
                            frames: list[bytes]) -> int:
        """deliver_egress for a group of frames bound for the SAME local
        wire (the bypass fast path delivers per-row groups): one egress
        extend, capture per frame. Returns the frames delivered: 0 when
        the wire is gone or crosses to another node (cross-node delivery
        goes through the plane's staged per-peer egress)."""
        wire = self.wires.get_by_key(pod_key, uid)
        if wire is None or wire.peer_ip:
            return 0
        wire.egress.extend(frames)
        if self.capture is not None:
            for f in frames:
                self.capture.record(wire.pod_key, wire.uid, f, "out")
        return len(frames)

    def deliver_egress(self, pod_key: str, uid: int, frame: bytes) -> bool:
        wire = self.wires.get_by_key(pod_key, uid)
        if wire is None:
            return False
        if wire.peer_ip:
            # cross-node wire: the shaped frame crosses to the peer daemon
            # (one unary SendToOnce per frame, reference grpcwire.go:452);
            # errors — including DEADLINE_EXCEEDED from a blackholed peer —
            # are counted and the frame dropped, not fatal (:452-459)
            try:
                self._peer_wire_client(wire.peer_ip).SendToOnce(
                    _pb().Packet(remot_intf_id=wire.peer_intf_id,
                                 frame=frame),
                    timeout=self.forward_timeout_s)
                return True
            except Exception:
                self.count_forward_errors(1)
                return False
        wire.egress.append(frame)
        if self.capture is not None:
            self.capture.record(wire.pod_key, wire.uid, frame, "out")
        return True


# Bulk ingestion RPCs skip protobuf deserialization entirely when the
# native PacketBatch decoder is available: the handler receives the RAW
# message bytes and decodes offsets/ids in one native call (the Python
# protobuf runtime would build a message object per frame at hundreds of
# ns each — the single largest ingestion cost at bulk rates). The
# daemon-side methods accept both forms, so in-process callers and
# builds without the native library keep the parsed-message path.
_RAW_BYTES_METHODS = frozenset({"SendToBulk", "InjectBulk"})


def _handler(fn, req_cls, resp_cls, streaming: bool, raw: bool = False):
    import grpc

    deser = (lambda b: b) if raw else req_cls.FromString
    if streaming:
        return grpc.stream_unary_rpc_method_handler(
            fn,
            request_deserializer=deser,
            response_serializer=resp_cls.SerializeToString,
        )
    return grpc.unary_unary_rpc_method_handler(
        fn,
        request_deserializer=deser,
        response_serializer=resp_cls.SerializeToString,
    )


_HEALTH_POOL = None


def _health_handlers(daemon: Daemon | None = None):
    """Standard grpc.health.v1 service (Check + server-streaming Watch),
    built dynamically like the parity proto — the daemon-side analogue of
    the reference controller's healthz/readyz probes (reference
    main.go:113-120). With a daemon, the status reflects REAL plane
    state: NOT_SERVING while the degradation ladder sits at its bottom
    rung or the watchdog has declared a live stall — so a generic
    k8s/grpc probe agrees with the rich Local.Health surface instead of
    reporting SERVING from a plane that is barely alive. Without a
    daemon (legacy callers), SERVING while the server is up; a stopped
    server fails the TCP dial either way."""
    import grpc
    from google.protobuf import (descriptor_pb2, descriptor_pool,
                                 message_factory)

    fd = descriptor_pb2.FileDescriptorProto(
        name="kubedtn_tpu_torch/wire/health_dynamic.proto",
        package="grpc.health.v1", syntax="proto3")
    req = descriptor_pb2.DescriptorProto(name="HealthCheckRequest")
    req.field.add(name="service", number=1,
                  type=descriptor_pb2.FieldDescriptorProto.TYPE_STRING,
                  label=descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL)
    resp = descriptor_pb2.DescriptorProto(name="HealthCheckResponse")
    enum = resp.enum_type.add(name="ServingStatus")
    for i, name in enumerate(("UNKNOWN", "SERVING", "NOT_SERVING",
                              "SERVICE_UNKNOWN")):
        enum.value.add(name=name, number=i)
    resp.field.add(name="status", number=1,
                   type=descriptor_pb2.FieldDescriptorProto.TYPE_ENUM,
                   label=descriptor_pb2.FieldDescriptorProto.LABEL_OPTIONAL,
                   type_name=".grpc.health.v1.HealthCheckResponse"
                             ".ServingStatus")
    fd.message_type.extend([req, resp])
    # a private pool, like proto.py's: the JAX package registers the same
    # service in the default pool, and both may live in one process
    global _HEALTH_POOL
    if _HEALTH_POOL is None:
        pool = descriptor_pool.DescriptorPool()
        pool.Add(fd)
        _HEALTH_POOL = pool
    filed = _HEALTH_POOL.FindFileByName(fd.name)
    req_cls = message_factory.GetMessageClass(
        filed.message_types_by_name["HealthCheckRequest"])
    resp_cls = message_factory.GetMessageClass(
        filed.message_types_by_name["HealthCheckResponse"])
    SERVING, NOT_SERVING = 1, 2

    def current_status() -> int:
        if daemon is None:
            return SERVING
        plane = daemon.dataplane
        if plane is None:
            return SERVING  # control plane up, no runner to degrade
        return SERVING if plane.health()["serving"] else NOT_SERVING

    def check(request, context):
        return resp_cls(status=current_status())

    # Each parked Watch stream pins one thread-pool worker for its whole
    # lifetime (sync gRPC consumes response generators from the pool), so
    # unbounded watchers could starve every other RPC on a 16-thread pool.
    # Cap the parked streams; watchers beyond the cap get the current
    # status and a clean stream close — the health protocol requires
    # clients to re-Watch on termination, so they degrade to polling
    # instead of starving the daemon.
    max_parked_watchers = 4
    watch_slots = threading.BoundedSemaphore(max_parked_watchers)

    def watch(request, context):
        # per the health protocol, Watch sends the current status and
        # then keeps the stream open, sending again only on change —
        # the parked loop polls the plane's serving verdict so a ladder
        # collapse (or recovery) reaches generic watchers without them
        # re-dialing
        last = current_status()
        yield resp_cls(status=last)
        if not watch_slots.acquire(blocking=False):
            return  # over the parking cap: close; client re-Watches
        try:
            done = threading.Event()
            context.add_callback(done.set)
            while not done.wait(timeout=0.5):
                now = current_status()
                if now != last:
                    last = now
                    yield resp_cls(status=now)
        finally:
            watch_slots.release()

    return {
        "Check": grpc.unary_unary_rpc_method_handler(
            check, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString),
        "Watch": grpc.unary_stream_rpc_method_handler(
            watch, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString),
    }


def make_server(daemon: Daemon, port: int = DEFAULT_PORT,
                max_workers: int = 16,
                host: str = "0.0.0.0",
                log_rpcs: bool = True):
    """Build the gRPC server with the three reference services plus the
    standard health service. log_rpcs installs the per-RPC structured
    logging interceptor (reference kubedtn.go:175-189); whether lines are
    emitted is the logging config's call (KUBEDTN_LOG_LEVEL). Returns
    (server, bound port)."""
    from concurrent import futures

    import grpc

    from kubedtn_tpu_torch.wire import proto as pb

    interceptors = ()
    if log_rpcs:
        from kubedtn_tpu_torch.utils.logging import GrpcLoggingInterceptor

        interceptors = (GrpcLoggingInterceptor(),)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         interceptors=interceptors)
    tables = [
        ("Local", pb.LOCAL_METHODS),
        ("Remote", pb.REMOTE_METHODS),
        ("WireProtocol", pb.WIRE_METHODS),
    ]
    from kubedtn_tpu_torch import native as _nat

    raw_ok = _nat.have_native()
    for service, methods in tables:
        handlers = {
            m: _handler(getattr(daemon, m), req, resp, streaming,
                        raw=raw_ok and m in _RAW_BYTES_METHODS)
            for m, (req, resp, streaming) in methods.items()
        }
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                f"{pb.PACKAGE}.{service}", handlers),
        ))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            "grpc.health.v1.Health", _health_handlers(daemon)),
    ))
    # all interfaces by default: peer daemons (Remote.Update) and the
    # physical-join CLI dial in from other hosts, like the reference's
    # :51111 listener (daemon/kubedtn/kubedtn.go:104)
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound
