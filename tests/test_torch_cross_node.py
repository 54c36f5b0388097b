"""Cross-node egress of the port: two live daemons, each a real gRPC
server on 127.0.0.1 port 0 with its own store and engine (CPU tensors).

Node A realizes its end of a cross-node link toward node B's VTEP and
completes B's end through Remote.Update; B's wire end is created by
AddGRPCWireRemote and A's end points at it. Frames injected at A are
shaped on A's egress row, staged in the remote ring and cross to B on
A's per-peer sender (one coalesced SendToBulk per tick), where they land
on the pod side (B's wire egress).

The first half ports the JAX package's tests/test_cross_node.py to the
port on both ends. The second half pairs a port daemon with a JAX one,
in both directions, on DETERMINISTIC links (latency, TBF rate with its
queue overflow, latency_corr without jitter: threefry and Philox draw
different bits): the receiver's pod-side egress per wire must equal the
JAX ⇄ JAX pair's, bytes and order, at depth 1 and 2.

Every wait is bounded; wall-time bounds sit at least 10× above what the
run needs, and the peers whose slowness a test relies on sleep several
times longer than that bound.
"""

import threading
import time
import types

import numpy as np
import pytest

import kubedtn_tpu.wire.client as jclient
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu_torch.wire.client as tclient
import kubedtn_tpu_torch.wire.proto as tpb
from kubedtn_tpu_torch.api.types import (Link, LinkProperties, Topology,
                                         TopologySpec)
from kubedtn_tpu_torch.runtime import WireDataPlane
from kubedtn_tpu_torch.topology.engine import SimEngine
from kubedtn_tpu_torch.topology.store import TopologyStore
from kubedtn_tpu_torch.wire.server import Daemon, make_server

from _torch_native_guard import assert_jax_wheel, ensure_jax_native
from test_torch_plane import DET_PROPS, DT, PKG, frames_for

FLUSH_S = 30.0   # bound on every flush_peers wait


def make_node(cls=Daemon, capacity=64, **daemon_kw):
    store = TopologyStore()
    engine = SimEngine(store, capacity=capacity, device="cpu")
    daemon = cls(engine, **daemon_kw)
    server, port = make_server(daemon, port=0, host="127.0.0.1",
                               log_rpcs=False)
    server.start()
    addr = f"127.0.0.1:{port}"
    engine.node_ip = addr  # HOST_IP equivalent; ports differ in-process
    return types.SimpleNamespace(store=store, engine=engine, daemon=daemon,
                                 server=server, addr=addr)


def seed(store, addr_a, addr_b, latency="10ms"):
    """Both daemons see the full cluster: r1 on node A, r2 on node B,
    one link uid 7."""
    props = LinkProperties(latency=latency)
    l1 = Link(local_intf="eth1", peer_intf="eth1", peer_pod="r2", uid=7,
              properties=props)
    l2 = Link(local_intf="eth1", peer_intf="eth1", peer_pod="r1", uid=7,
              properties=props)
    t1 = Topology(name="r1", spec=TopologySpec(links=[l1]))
    t2 = Topology(name="r2", spec=TopologySpec(links=[l2]))
    t1.status.src_ip, t1.status.net_ns = addr_a, "/proc/1/ns/net"
    t2.status.src_ip, t2.status.net_ns = addr_b, "/proc/2/ns/net"
    for t in (t1, t2):
        store.create(t)
    return t1, t2


@pytest.fixture
def two_nodes():
    a, b = make_node(), make_node()
    yield a, b
    for n in (a, b):
        plane = n.daemon.dataplane
        if plane is not None:
            plane.stop()
        n.server.stop(0)


def wire_pair(a, b, uid=7, pod_a="r1", pod_b="r2"):
    """B's end by AddGRPCWireRemote over gRPC, then A's end pointing at
    it (the reference's CreateGRPCWireRemoteTriggered order)."""
    client_b = tclient.DaemonClient(b.addr)
    try:
        resp = client_b.AddGRPCWireRemote(tpb.WireDef(
            local_pod_name=pod_b, kube_ns="default", link_uid=uid,
            intf_name_in_pod="eth1", peer_ip=a.addr))
    finally:
        client_b.close()
    assert resp.response
    wire_a = a.daemon._add_wire(tpb.WireDef(
        local_pod_name=pod_a, kube_ns="default", link_uid=uid,
        intf_name_in_pod="eth1", peer_ip=b.addr,
        peer_intf_id=resp.peer_intf_id))
    return wire_a, b.daemon.wires.get_by_key(f"default/{pod_b}", uid)


def test_cross_node_link_completed_via_remote_update(two_nodes):
    a, b = two_nodes
    t1, _ = seed(a.store, a.addr, b.addr)
    seed(b.store, a.addr, b.addr)
    assert a.engine.add_links(t1, t1.spec.links)
    assert a.engine.link_row("default/r1", 7)["latency_us"] == 10_000
    assert b.engine.link_row("default/r2", 7)["latency_us"] == 10_000
    assert a.engine.stats.remote_errors == 0


def test_cross_node_frames_shaped_then_tunneled(two_nodes):
    """Pod frame at A -> shaped on A's egress row (10ms) -> staged ->
    A's per-peer sender -> pod-side egress at B."""
    a, b = two_nodes
    t1, _ = seed(a.store, a.addr, b.addr)
    seed(b.store, a.addr, b.addr)
    assert a.engine.add_links(t1, t1.spec.links)
    wire_a, wire_b = wire_pair(a, b)
    dp = WireDataPlane(a.daemon)
    client_a = tclient.DaemonClient(a.addr)
    frame = b"\x02" * 12 + b"\x08\x06" + b"\x00" * 40
    # pod-origin injection on a cross-daemon wire uses InjectFrame
    assert client_a.InjectFrame(tpb.Packet(remot_intf_id=wire_a.wire_id,
                                           frame=frame)).response
    client_a.close()
    dp.tick(now_s=50.0)
    assert len(wire_b.egress) == 0      # 10ms not yet elapsed
    dp.tick(now_s=50.011)               # past the netem delay: crosses now
    assert dp.flush_peers(FLUSH_S)
    assert list(wire_b.egress) == [frame]
    assert a.daemon.forward_errors == 0
    assert dp.ring_dropped == 0 and dp.peer_queue_dropped == 0


def test_sendtoonce_on_cross_wire_is_pod_bound(two_nodes):
    """Frames arriving over SendToOnce for a peer_ip wire go straight to
    the pod side (already shaped by the sender), never back into
    shaping — no ping-pong between daemons."""
    _, b = two_nodes
    wire = b.daemon._add_wire(tpb.WireDef(
        local_pod_name="r2", kube_ns="default", link_uid=7,
        intf_name_in_pod="eth1", peer_ip="127.0.0.1:9", peer_intf_id=1))
    client = tclient.DaemonClient(b.addr)
    client.SendToOnce(tpb.Packet(remot_intf_id=wire.wire_id,
                                 frame=b"x" * 60))
    client.close()
    assert list(wire.egress) == [b"x" * 60]
    assert not wire.ingress


def test_deliver_egress_crosses_with_one_sendtoonce(two_nodes):
    """deliver_egress on a cross wire is one unary SendToOnce to the
    peer, landing pod-side there; deliver_egress_bulk refuses a cross
    wire (its frames go through the staged per-peer egress)."""
    a, b = two_nodes
    wire_a, wire_b = wire_pair(a, b)
    assert a.daemon.deliver_egress("default/r1", 7, b"y" * 60)
    assert a.daemon.deliver_egress_bulk("default/r1", 7, [b"z"]) == 0
    assert list(wire_b.egress) == [b"y" * 60]
    assert not wire_a.egress and a.daemon.forward_errors == 0


def test_deliver_egress_deadline_on_blackholed_peer():
    """A peer daemon that accepts the connection but never answers must
    cost at most forward_timeout_s per frame, not stall the caller."""
    release = threading.Event()

    class BlackholeDaemon(Daemon):
        def SendToOnce(self, request, context):
            release.wait(30)
            return tpb.BoolResponse(response=True)

    b = make_node(BlackholeDaemon, capacity=16)
    try:
        engine_a = SimEngine(TopologyStore(), capacity=16, device="cpu")
        daemon_a = Daemon(engine_a, forward_timeout_s=0.2)
        daemon_a._add_wire(tpb.WireDef(
            local_pod_name="r1", kube_ns="default", link_uid=7,
            intf_name_in_pod="eth1", peer_ip=b.addr, peer_intf_id=1))
        t0 = time.perf_counter()
        ok = daemon_a.deliver_egress("default/r1", 7, b"x" * 60)
        elapsed = time.perf_counter() - t0
        assert ok is False
        assert daemon_a.forward_errors == 1
        assert elapsed < 3.0, f"forward blocked {elapsed:.1f}s"
    finally:
        release.set()
        b.server.stop(0)


def _unshaped_pair(b, peer_of_a="127.0.0.1:1"):
    """Node A (no server) with r1 -> r2 unshaped toward `b`, and the
    wire pair: (engine_a, daemon_a, wire_a, wire_b)."""
    store_a = TopologyStore()
    engine_a = SimEngine(store_a, capacity=64, device="cpu")
    engine_a.node_ip = peer_of_a
    daemon_a = Daemon(engine_a)
    t1, _ = seed(store_a, engine_a.node_ip, b.addr, latency="")
    engine_a.add_links(t1, t1.spec.links)  # A's local row, unshaped
    wire_b = b.daemon._add_wire(tpb.WireDef(
        local_pod_name="r2", kube_ns="default", link_uid=7,
        intf_name_in_pod="eth1", peer_ip=peer_of_a, peer_intf_id=1))
    wire_a = daemon_a._add_wire(tpb.WireDef(
        local_pod_name="r1", kube_ns="default", link_uid=7,
        intf_name_in_pod="eth1", peer_ip=b.addr,
        peer_intf_id=wire_b.wire_id))
    return engine_a, daemon_a, wire_a, wire_b


def test_cross_node_egress_batches_over_sendtostream():
    """Released cross-node frames cross as ONE coalesced SendToBulk
    stream per peer per tick — not one RPC per frame, not the per-frame
    stream."""
    class CountingDaemon(Daemon):
        stream_calls = 0
        bulk_calls = 0

        def SendToStream(self, request_iterator, context):
            resp = super().SendToStream(request_iterator, context)
            type(self).stream_calls += 1
            return resp

        def SendToBulk(self, request_iterator, context):
            resp = super().SendToBulk(request_iterator, context)
            type(self).bulk_calls += 1
            return resp

    b = make_node(CountingDaemon)
    dp = None
    try:
        _, daemon_a, wire_a, wire_b = _unshaped_pair(b)
        dp = WireDataPlane(daemon_a, max_slots=16)
        n = 6
        for i in range(n):
            wire_a.ingress.append(bytes([i]) * 60)
        dp.tick(now_s=5.0)
        dp.tick(now_s=5.001)  # unshaped: released immediately
        assert dp.flush_peers(FLUSH_S)
        assert list(wire_b.egress) == [bytes([i]) * 60 for i in range(n)]
        assert CountingDaemon.bulk_calls == 1
        assert CountingDaemon.stream_calls == 0
        assert daemon_a.forward_errors == 0
    finally:
        if dp is not None:
            dp.stop()
        b.server.stop(0)


def test_cross_node_egress_falls_back_to_stream_for_reference_peer():
    """A peer that doesn't implement SendToBulk (a reference-built
    daemon) answers UNIMPLEMENTED once; the sender latches the per-frame
    SendToStream for it and loses nothing."""
    import grpc

    class RefDaemon(Daemon):
        stream_calls = 0

        def SendToBulk(self, request_iterator, context):
            context.abort(grpc.StatusCode.UNIMPLEMENTED,
                          "method SendToBulk not implemented")

        def SendToStream(self, request_iterator, context):
            resp = super().SendToStream(request_iterator, context)
            type(self).stream_calls += 1
            return resp

    b = make_node(RefDaemon)
    dp = None
    try:
        _, daemon_a, wire_a, wire_b = _unshaped_pair(b)
        dp = WireDataPlane(daemon_a, max_slots=16)
        n = 6
        for i in range(n):
            wire_a.ingress.append(bytes([i]) * 60)
        dp.tick(now_s=5.0)
        dp.tick(now_s=5.001)
        assert dp.flush_peers(FLUSH_S)
        assert list(wire_b.egress) == [bytes([i]) * 60 for i in range(n)]
        assert RefDaemon.stream_calls == 1
        assert daemon_a.peer_bulk_ok.get(b.addr) is False
        assert daemon_a.forward_errors == 0
        # the second batch goes straight to the stream, no bulk retry
        for i in range(3):
            wire_a.ingress.append(bytes([0x40 + i]) * 60)
        dp.tick(now_s=5.1)
        dp.tick(now_s=5.101)
        assert dp.flush_peers(FLUSH_S)
        assert len(wire_b.egress) == n + 3
        assert list(wire_b.egress)[n:] == [bytes([0x40 + i]) * 60
                                           for i in range(3)]
        assert RefDaemon.stream_calls == 2
    finally:
        if dp is not None:
            dp.stop()
        b.server.stop(0)


def test_slow_peer_does_not_stall_local_delivery():
    """Egress to each peer runs on its own sender thread: a SLOW peer
    costs only its own wires (ticks stay fast, local delivery goes on,
    its frames still arrive) and frames to a BLACKHOLED peer wait in
    that sender's bounded outage buffer; stop() gives them up, counted.
    The slow peer sleeps SLOW_S per RPC and the blackhole until released:
    a tick that blocked on either would take at least SLOW_S."""
    SLOW_S = 2.0
    release = threading.Event()

    class SlowDaemon(Daemon):
        def SendToBulk(self, request_iterator, context):
            time.sleep(SLOW_S)
            return super().SendToBulk(request_iterator, context)

    class BlackholeDaemon(Daemon):
        def SendToBulk(self, request_iterator, context):
            release.wait(60)
            return tpb.BoolResponse(response=False)

        SendToStream = SendToBulk

    slow = make_node(SlowDaemon, capacity=16)
    hole = make_node(BlackholeDaemon, capacity=16)
    dp = None
    try:
        slow_wire = slow.daemon._add_wire(tpb.WireDef(
            local_pod_name="rs", kube_ns="default", link_uid=7,
            intf_name_in_pod="eth1", peer_ip="127.0.0.1:1",
            peer_intf_id=1))
        store_a = TopologyStore()
        engine_a = SimEngine(store_a, capacity=64, device="cpu")
        engine_a.node_ip = "127.0.0.1:1"
        # the forward deadline lies between the slow peer's SLOW_S
        # (succeeds) and the blackhole's hold (fails on the deadline)
        daemon_a = Daemon(engine_a, forward_timeout_s=2 * SLOW_S)
        links = [
            Link(local_intf="eth1", peer_intf="eth1", peer_pod="l2", uid=1),
            Link(local_intf="eth2", peer_intf="eth1",
                 peer_pod="physical/" + slow.addr, uid=7),
            Link(local_intf="eth3", peer_intf="eth1",
                 peer_pod="physical/" + hole.addr, uid=8),
        ]
        t1 = Topology(name="l1", spec=TopologySpec(links=links))
        t2 = Topology(name="l2", spec=TopologySpec(links=[
            Link(local_intf="eth1", peer_intf="eth1", peer_pod="l1",
                 uid=1)]))
        for t in (t1, t2):
            t.status.src_ip, t.status.net_ns = "127.0.0.1:1", "/proc/1/ns"
            store_a.create(t)
        assert engine_a.add_links(t1, [links[0]])
        assert engine_a.add_links(t2, t2.spec.links)
        assert engine_a.add_links(t1, links[1:])

        def wd(pod, uid, intf, peer_ip="", peer_intf_id=0):
            return tpb.WireDef(local_pod_name=pod, kube_ns="default",
                               link_uid=uid, intf_name_in_pod=intf,
                               peer_ip=peer_ip, peer_intf_id=peer_intf_id)

        wl1 = daemon_a._add_wire(wd("l1", 1, "eth1"))
        wl2 = daemon_a._add_wire(wd("l2", 1, "eth1"))
        ws = daemon_a._add_wire(wd("l1", 7, "eth2", slow.addr,
                                   slow_wire.wire_id))
        wh = daemon_a._add_wire(wd("l1", 8, "eth3", hole.addr, 1))
        dp = WireDataPlane(daemon_a, dt_us=1_000.0)
        n = 4
        for i in range(n):
            ws.ingress.append(bytes([0x10 + i]) * 60)
            wh.ingress.append(bytes([0x20 + i]) * 60)
        dp.tick(now_s=2.0)
        t0 = time.perf_counter()
        dp.tick(now_s=2.001)      # releases + hands to the per-peer senders
        for i in range(n):
            wl1.ingress.append(bytes([0x30 + i]) * 60)
            dp.tick(now_s=2.002 + i * 0.001)
        tick_wall = time.perf_counter() - t0
        assert tick_wall < 0.75 * SLOW_S, (
            f"ticks took {tick_wall:.2f}s: the tick thread blocked on a "
            "peer RPC")
        assert [bytes(f) for f in wl2.egress] == \
            [bytes([0x30 + i]) * 60 for i in range(n)]
        deadline = time.monotonic() + 10 * SLOW_S
        while len(slow_wire.egress) < n and time.monotonic() < deadline:
            time.sleep(0.02)
        assert list(slow_wire.egress) == [bytes([0x10 + i]) * 60
                                          for i in range(n)]
        stats = dp.peer_fault_stats()[hole.addr]
        assert stats["buffered"] == n
        assert daemon_a.forward_errors == 0
        assert dp.peer_queue_dropped == 0
        hole_sender = dp._peer_senders[hole.addr]
        dp.stop()
        dp = None
        # stop() with the peer still dead gives the buffer up — counted
        deadline = time.monotonic() + 10 * SLOW_S
        while hole_sender.dropped < n and time.monotonic() < deadline:
            time.sleep(0.02)
        assert hole_sender.dropped == n
    finally:
        release.set()
        if dp is not None:
            dp.stop()
        slow.server.stop(0)
        hole.server.stop(0)


def test_plane_restart_recreates_peer_senders(two_nodes):
    """stop() drops the one-shot sender threads, so a plane ticked again
    after it makes fresh ones instead of enqueueing into a dead queue."""
    a, b = two_nodes
    t1, _ = seed(a.store, a.addr, b.addr, latency="")
    seed(b.store, a.addr, b.addr, latency="")
    assert a.engine.add_links(t1, t1.spec.links)
    wire_a, wire_b = wire_pair(a, b)
    dp = WireDataPlane(a.daemon)
    wire_a.ingress.append(b"\x01" * 60)
    dp.tick(now_s=10.0)
    dp.tick(now_s=10.001)
    assert dp.flush_peers(FLUSH_S)
    assert len(wire_b.egress) == 1
    assert len(dp._peer_senders) == 1
    old = next(iter(dp._peer_senders.values()))
    dp.stop()
    assert not dp._peer_senders
    assert not old._thread.is_alive()
    wire_a.ingress.append(b"\x02" * 60)
    dp.tick(now_s=10.1)
    dp.tick(now_s=10.101)
    assert dp.flush_peers(FLUSH_S), "egress black-holed after restart"
    assert list(wire_b.egress) == [b"\x01" * 60, b"\x02" * 60]
    assert a.daemon.forward_errors == 0


def test_ring_overflow_charged_to_the_row(two_nodes):
    """A release that overflows the 4 MiB staging ring drops the rest,
    counted in ring_dropped and charged per row to dropped_ring; what was
    staged still crosses, in order."""
    a, b = two_nodes
    t1, _ = seed(a.store, a.addr, b.addr, latency="")
    seed(b.store, a.addr, b.addr, latency="")
    assert a.engine.add_links(t1, t1.spec.links)
    wire_a, wire_b = wire_pair(a, b)
    dp = WireDataPlane(a.daemon, max_slots=4096)
    n = 3000  # ~1.4 KiB entries: ~3000 of them overflow 4 MiB
    frames = [i.to_bytes(4, "big") * 350 for i in range(n)]
    wire_a.ingress.extend(frames)
    dp.tick(now_s=1.0)
    dp.tick(now_s=1.001)
    assert dp.flush_peers(FLUSH_S)
    got = list(wire_b.egress)
    assert 0 < dp.ring_dropped < n
    assert len(got) + dp.ring_dropped == n == dp.shaped
    assert got == frames[:len(got)]
    row = a.engine.row_of("default/r1", 7)
    assert float(dp.counters.dropped_ring[row]) == dp.ring_dropped
    assert float(dp.counters.dropped_ring.sum()) == dp.ring_dropped


# -- port ⇄ JAX pairs, on deterministic links ---------------------------------

PAIR_COUNTS = (12, 30, 70, 24)   # frames per wire and tick (seq: > 64)
PAIR_FEED_TICKS = 6
PAIR_DRAIN_TICKS = 30


def pair_node(pkg):
    eng, st, _rec, srv, _rt, _ty = PKG[pkg]
    store = st.TopologyStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    engine = eng.SimEngine(store, capacity=64, **kw)
    daemon = srv.Daemon(engine)
    server, port = srv.make_server(daemon, port=0, host="127.0.0.1",
                                   log_rpcs=False)
    server.start()
    engine.node_ip = f"127.0.0.1:{port}"
    return types.SimpleNamespace(pkg=pkg, store=store, engine=engine,
                                 daemon=daemon, server=server,
                                 addr=engine.node_ip)


def pair_run(send_pkg, recv_pkg, depth):
    """Sender A of `send_pkg`, receiver B of `recv_pkg`: pods a_i on A,
    b_i on B, link uid i+1 with DET_PROPS[i]; A realizes its rows (and
    B's through Remote.Update); B's wire ends by AddGRPCWireRemote, A's
    pointing at them; PAIR_FEED_TICKS explicit-clock ticks of feed, then
    idle ticks, then flush_peers. Returns B's pod-side egress per wire
    and A's plane."""
    a, b = pair_node(send_pkg), pair_node(recv_pkg)
    plane = None
    try:
        for node in (a, b):
            nty = PKG[node.pkg][5]
            for i, p in enumerate(DET_PROPS):
                lp = nty.LinkProperties(**p)
                for x, y, addr in ((f"a{i}", f"b{i}", a.addr),
                                   (f"b{i}", f"a{i}", b.addr)):
                    t = nty.Topology(name=x, spec=nty.TopologySpec(links=[
                        nty.Link(local_intf="eth1", peer_intf="eth1",
                                 peer_pod=y, uid=i + 1, properties=lp)]))
                    t.status.src_ip, t.status.net_ns = addr, f"/ns/{x}"
                    node.store.create(t)
        for i in range(len(DET_PROPS)):
            t = a.store.get("default", f"a{i}")
            assert a.engine.add_links(t, t.spec.links)
        cmod = tclient if recv_pkg == "torch" else jclient
        pb = tpb if recv_pkg == "torch" else jpb
        c = cmod.DaemonClient(b.addr)
        win, wout = [], []
        for i in range(len(DET_PROPS)):
            resp = c.AddGRPCWireRemote(pb.WireDef(
                local_pod_name=f"b{i}", kube_ns="default", link_uid=i + 1,
                intf_name_in_pod="eth1", peer_ip=a.addr))
            win.append(a.daemon._add_wire(types.SimpleNamespace(
                local_pod_name=f"a{i}", kube_ns="default", link_uid=i + 1,
                intf_name_in_pod="eth1", veth_name_local_host="",
                peer_ip=b.addr, peer_intf_id=resp.peer_intf_id)))
            wout.append(b.daemon.wires.get_by_key(f"default/b{i}", i + 1))
        c.close()
        if send_pkg == "jax":
            ensure_jax_native()
        plane = PKG[send_pkg][4].WireDataPlane(
            a.daemon, dt_us=DT * 1e6, seed=0, pipeline_depth=depth)
        if send_pkg == "jax":
            assert_jax_wheel(plane)
        plane.pipeline_explicit_clock = True
        rng = np.random.default_rng(1)
        for t in range(PAIR_FEED_TICKS + PAIR_DRAIN_TICKS):
            if t < PAIR_FEED_TICKS:
                for k, w in enumerate(win):
                    w.ingress.extend(frames_for(k, t, PAIR_COUNTS[k], rng))
            plane.tick(now_s=(t + 1) * DT)
        plane.flush()
        assert plane.flush_peers(FLUSH_S)
        assert plane.tick_errors == 0 and not plane._pending
        assert a.daemon.forward_errors == 0 and b.daemon.bulk_unresolved == 0
        assert plane.ring_dropped == 0 and plane.peer_queue_dropped == 0
        got = [[bytes(f) for f in w.egress] for w in wout]
        return got, plane
    finally:
        if plane is not None:
            plane.stop()
        a.server.stop(0)
        b.server.stop(0)


@pytest.fixture(scope="module")
def jax_pairs():
    """The JAX ⇄ JAX pair's receiver egress, once per depth."""
    return {d: pair_run("jax", "jax", d) for d in (1, 2)}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("send,recv", [("torch", "jax"), ("jax", "torch"),
                                       ("torch", "torch")])
def test_pair_egress_equals_jax_pair(jax_pairs, send, recv, depth):
    got, plane = pair_run(send, recv, depth)
    want, jplane = jax_pairs[depth]
    assert [len(w) for w in got] == [len(w) for w in want]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"wire {k}: pod-side egress differs"
    assert (plane.shaped, plane.dropped) == (jplane.shaped, jplane.dropped)
    assert all(len(w) > 0 for w in got)
    assert sum(len(w) for w in got) == plane.shaped
    assert plane.dropped > 0
    if send == "torch":
        assert plane.fallbacks > 0  # the TBF fallback re-shape ran
