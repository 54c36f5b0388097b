"""The port's wire layer (wire/proto.py, wire/client.py, wire/server.py)
against the JAX package's: the schema serialises byte for byte like the
JAX package's for the same fields; the Local, Remote and WireProtocol
RPCs answer over real gRPC on port 0; a JAX-package DaemonClient talks
to a port server; and importing the port's engine, runtime and server
loads neither grpc nor protobuf."""

import os
import subprocess
import sys
import types
from pathlib import Path

import grpc
import pytest

import kubedtn_tpu.wire.client as jclient
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu_torch.wire.client as tclient
import kubedtn_tpu_torch.wire.proto as tpb
from kubedtn_tpu_torch.api.types import (Link, LinkProperties, Topology,
                                         TopologySpec)
from kubedtn_tpu_torch.topology.engine import SimEngine
from kubedtn_tpu_torch.topology.reconciler import Reconciler
from kubedtn_tpu_torch.topology.store import TopologyStore
from kubedtn_tpu_torch.wire.server import Daemon, make_server

ROOT = Path(__file__).resolve().parent.parent


def _props(pb):
    return pb.LinkProperties(latency="10ms", jitter="1ms", loss="2.5",
                             rate="100Mbit", gap=3, reorder_prob="1",
                             corrupt_corr="9")


def _link(pb, uid=7):
    return pb.Link(peer_pod="b", local_intf="eth1", peer_intf="eth2",
                   local_ip="10.0.0.1/24", peer_ip="10.0.0.2/24", uid=uid,
                   local_mac="02:00:00:00:00:01", properties=_props(pb))


MESSAGES = {
    "LinkProperties": _props,
    "Link": _link,
    "Pod": lambda pb: pb.Pod(name="a", src_ip="10.0.0.1", net_ns="/ns/a",
                             kube_ns="default",
                             links=[_link(pb, 1), _link(pb, 2)]),
    "LinksBatchQuery": lambda pb: pb.LinksBatchQuery(
        local_pod=pb.Pod(name="a", kube_ns="x"), links=[_link(pb)]),
    "RemotePod": lambda pb: pb.RemotePod(
        net_ns="n", intf_name="eth1", intf_ip="1.2.3.4", peer_vtep="5.6.7.8",
        vni=5007, kube_ns="default", name="b", properties=_props(pb)),
    "WireDef": lambda pb: pb.WireDef(
        peer_intf_id=3, peer_ip="", intf_name_in_pod="eth1",
        local_pod_name="a", kube_ns="default", link_uid=9,
        veth_name_local_host="aeth1-0001"),
    "Packet": lambda pb: pb.Packet(remot_intf_id=1001, frame=b"\x00\xff" * 40,
                                   trace_id=123456789),
    "PacketBatch": lambda pb: pb.PacketBatch(packets=[
        pb.Packet(remot_intf_id=1001 + i, frame=bytes([i]) * (i + 1))
        for i in range(5)]),
    "HealthResponse": lambda pb: pb.HealthResponse(
        ok=True, node="10.0.0.1", running=True, serving=True,
        heartbeat_age_s=0.25, degrade_level=1, ticks=99, capacity=1024,
        active_rows=10, headroom_rows=1014),
    "ObserveLinksResponse": lambda pb: pb.ObserveLinksResponse(
        ok=True, covered_seconds=1.5, links=[pb.LinkStats(
            pod="a", namespace="default", uid=1, row=3, tx=10.0,
            delivered=9.0, p50_us=100.0, p99_us=-1.0)]),
    "ObserveTraceResponse": lambda pb: pb.ObserveTraceResponse(
        ok=True, sampled=4, recent_traces=[5, 6], events=[pb.TraceEvent(
            trace_id=5, t=1.0, node="n", stage="ingress", detail="x=1")]),
    "ObservePausesResponse": lambda pb: pb.ObservePausesResponse(
        ok=True, enabled=True, uptime_s=3.0, causes=[pb.PauseCauseStat(
            cause="compact", count=2, seconds=0.5, tick_buckets=[1, 2])]),
    "GenerateNodeInterfaceNameResponse": lambda pb:
        pb.GenerateNodeInterfaceNameResponse(ok=True,
                                             node_intf_name="aeth1-0001"),
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_proto_serialises_like_jax(name):
    a = MESSAGES[name](tpb).SerializeToString(deterministic=True)
    b = MESSAGES[name](jpb).SerializeToString(deterministic=True)
    assert a == b and len(a) > 0
    # and each side parses the other's bytes
    assert getattr(tpb, name).FromString(b).SerializeToString(
        deterministic=True) == a


@pytest.mark.parametrize("table", ["LOCAL_METHODS", "REMOTE_METHODS",
                                   "WIRE_METHODS"])
def test_service_tables_match_jax(table):
    t, j = getattr(tpb, table), getattr(jpb, table)
    assert list(t) == list(j)
    for m in t:
        assert [c.DESCRIPTOR.full_name for c in t[m][:2]] == \
            [c.DESCRIPTOR.full_name for c in j[m][:2]]
        assert t[m][2] == j[m][2]


def test_schema_lives_in_its_own_pool():
    assert tpb.Packet.DESCRIPTOR.file.pool is not \
        jpb.Packet.DESCRIPTOR.file.pool
    assert tpb.PACKAGE == jpb.PACKAGE == "proto.v1"


@pytest.mark.parametrize("host,want", [
    ("10.0.0.1", "10.0.0.1:51111"), ("10.0.0.1:9", "10.0.0.1:9"),
    ("fe80::1", "[fe80::1]:51111"), ("[fe80::1]:7", "[fe80::1]:7")])
def test_daemon_address(host, want):
    assert tclient.daemon_address(host) == jclient.daemon_address(host)
    assert tclient.daemon_address(host) == want


@pytest.fixture(scope="module")
def served():
    """A port Daemon (CPU engine, one pod pair at 1 ms) behind a real
    gRPC server on port 0."""
    store = TopologyStore()
    engine = SimEngine(store, capacity=16, device="cpu")
    props = LinkProperties(latency="1ms")
    for a, b in (("a", "b"), ("b", "a")):
        store.create(Topology(name=a, spec=TopologySpec(links=[
            Link(local_intf="eth1", peer_intf="eth1", peer_pod=b, uid=1,
                 properties=props)])))
    engine.setup_pod("a")
    engine.setup_pod("b")
    Reconciler(store, engine).drain()
    daemon = Daemon(engine)
    server, port = make_server(daemon, port=0, host="127.0.0.1",
                               log_rpcs=False)
    server.start()
    yield types.SimpleNamespace(daemon=daemon, engine=engine, port=port)
    server.stop(0)


@pytest.fixture(params=["port", "jax"])
def client(served, request):
    mod = tclient if request.param == "port" else jclient
    c = mod.DaemonClient(f"127.0.0.1:{served.port}")
    yield types.SimpleNamespace(c=c, pb=tpb if request.param == "port"
                                else jpb)
    c.close()


def test_rpc_get_and_setalive(served, client):
    pb, c = client.pb, client.c
    pod = c.Get(pb.PodQuery(name="a", kube_ns="default"))
    assert pod.name == "a" and pod.src_ip == "10.0.0.1"
    assert [l.uid for l in pod.links] == [1]
    with pytest.raises(grpc.RpcError) as e:
        c.Get(pb.PodQuery(name="nope", kube_ns="default"))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    assert c.SetAlive(pb.Pod(name="a", kube_ns="default",
                             src_ip="10.0.0.1", net_ns="/ns/a")).response


def test_rpc_update_links_reshapes_the_row(served, client):
    pb, c = client.pb, client.c
    link = pb.Link(peer_pod="b", local_intf="eth1", peer_intf="eth1", uid=1,
                   properties=pb.LinkProperties(latency="3ms"))
    q = pb.LinksBatchQuery(local_pod=pb.Pod(name="a", kube_ns="default"),
                           links=[link])
    assert c.UpdateLinks(q).response
    row = served.engine.row_of("default/a", 1)
    assert float(served.engine.state.props[row, 0]) == 3000.0
    q.links[0].properties.latency = "1ms"  # (q holds a copy of link)
    assert c.UpdateLinks(q).response
    assert float(served.engine.state.props[row, 0]) == 1000.0


def test_rpc_wire_lifecycle_and_frames(served, client):
    pb, c = client.pb, client.c
    wd = pb.WireDef(local_pod_name="a", kube_ns="default", link_uid=1,
                    intf_name_in_pod="eth1")
    assert not c.GRPCWireExists(wd).response
    assert c.AddGRPCWireLocal(wd).response
    assert c.GRPCWireExists(wd).response
    wire = served.daemon.wires.get_by_key("default/a", 1)
    name = c.GenerateNodeInterfaceName(pb.GenerateNodeInterfaceNameRequest(
        pod_name="a", pod_intf_name="eth1"))
    assert name.ok and name.node_intf_name.startswith("aeth1-")
    wid = wire.wire_id
    assert c.SendToOnce(pb.Packet(remot_intf_id=wid, frame=b"one")).response
    assert c.InjectFrame(pb.Packet(remot_intf_id=wid, frame=b"two")).response
    assert c.SendToStream(iter([pb.Packet(remot_intf_id=wid, frame=b"3"),
                                pb.Packet(remot_intf_id=wid,
                                          frame=b"4")])).response
    batch = pb.PacketBatch(packets=[pb.Packet(remot_intf_id=wid,
                                              frame=bytes([i]) * 3)
                                    for i in range(5)])
    assert c.SendToBulk(iter([batch])).response
    assert c.InjectBulk(iter([batch])).response
    with pytest.raises(grpc.RpcError) as e:
        c.SendToOnce(pb.Packet(remot_intf_id=1, frame=b"x"))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    from kubedtn_tpu_torch.wire.server import flatten_frames

    got = flatten_frames(list(wire.ingress))
    assert got == [b"one", b"two", b"3", b"4"] + \
        [bytes([i]) * 3 for i in range(5)] * 2
    assert len(wire.ingress) == 14
    assert c.RemGRPCWire(wd).response
    assert not c.GRPCWireExists(wd).response


def _serve_fresh(pkg: str):
    """A fresh Daemon of the port or of the JAX package (no pods) behind
    a real gRPC server on port 0: (daemon, server, port)."""
    import kubedtn_tpu.topology.engine as jeng
    import kubedtn_tpu.topology.store as jst
    import kubedtn_tpu.wire.server as jsrv

    if pkg == "port":
        daemon = Daemon(SimEngine(TopologyStore(), capacity=16,
                                  device="cpu"))
        server, port = make_server(daemon, port=0, host="127.0.0.1",
                                   log_rpcs=False)
    else:
        daemon = jsrv.Daemon(jeng.SimEngine(jst.TopologyStore(),
                                            capacity=16))
        server, port = jsrv.make_server(daemon, port=0, host="127.0.0.1",
                                        log_rpcs=False)
    server.start()
    return daemon, server, port


def test_rpc_cross_node_wire_is_created_like_jax(client):
    """AddGRPCWireRemote / AddGRPCWireLocal with peer_ip set build the
    cross-daemon wire as the JAX Daemon does: the same answers (the
    Remote form returns the new wire's id as peer_intf_id) and the same
    wire fields."""
    pb, mod = client.pb, (tclient if client.pb is tpb else jclient)
    got = {}
    for pkg in ("port", "jax"):
        daemon, server, port = _serve_fresh(pkg)
        c = mod.DaemonClient(f"127.0.0.1:{port}")
        try:
            remote = c.AddGRPCWireRemote(pb.WireDef(
                local_pod_name="a", kube_ns="default", link_uid=1,
                intf_name_in_pod="eth1", peer_ip="10.9.9.9"))
            local = c.AddGRPCWireLocal(pb.WireDef(
                local_pod_name="a", kube_ns="default", link_uid=2,
                intf_name_in_pod="eth2", peer_ip="10.9.9.9",
                peer_intf_id=4))
            again = c.AddGRPCWireRemote(pb.WireDef(
                local_pod_name="a", kube_ns="default", link_uid=1,
                intf_name_in_pod="eth1", peer_ip="10.9.9.9"))
            wires = [(w.wire_id, w.uid, w.pod_key, w.node_iface_name,
                      w.peer_intf_id, w.peer_ip)
                     for w in daemon.wires.all()]
            got[pkg] = ((remote.response, remote.peer_intf_id),
                        local.response,
                        (again.response, again.peer_intf_id), wires)
        finally:
            c.close()
            server.stop(0)
    assert got["port"] == got["jax"]
    assert got["port"][0] == (True, 1001)
    assert got["port"][2] == (True, 1001)  # idempotent per (pod, uid)
    assert [w[5] for w in got["port"][3]] == ["10.9.9.9"] * 2


def test_rpc_inject_bulk_is_ingress_send_to_bulk_is_egress(client):
    """On a cross-daemon wire, SendToBulk (and the per-frame SendToOnce /
    SendToStream) come from the peer daemon and land on the pod side
    (egress); InjectBulk and InjectFrame are pod-origin ingress, on
    every wire kind."""
    pb, mod = client.pb, (tclient if client.pb is tpb else jclient)
    daemon, server, port = _serve_fresh("port")
    c = mod.DaemonClient(f"127.0.0.1:{port}")
    try:
        wire = daemon._add_wire(pb.WireDef(
            local_pod_name="a", kube_ns="default", link_uid=1,
            intf_name_in_pod="eth1", peer_ip="10.9.9.9", peer_intf_id=4))
        wid = wire.wire_id

        def batch(tag):
            return pb.PacketBatch(packets=[
                pb.Packet(remot_intf_id=wid, frame=bytes([tag, i]) * 8)
                for i in range(4)])

        assert c.SendToBulk(iter([batch(1)])).response
        assert c.SendToOnce(pb.Packet(remot_intf_id=wid,
                                      frame=b"once")).response
        assert c.InjectBulk(iter([batch(2)])).response
        assert c.InjectFrame(pb.Packet(remot_intf_id=wid,
                                       frame=b"inject")).response
        from kubedtn_tpu_torch.wire.server import flatten_frames

        assert list(wire.egress) == [bytes([1, i]) * 8 for i in range(4)] \
            + [b"once"]
        assert flatten_frames(list(wire.ingress)) == \
            [bytes([2, i]) * 8 for i in range(4)] + [b"inject"]
        assert daemon.bulk_unresolved == 0
    finally:
        c.close()
        server.stop(0)


def _jax_daemon():
    """The JAX package's Daemon over the same pod pair as `served`."""
    from kubedtn_tpu.api.types import Link as JLink
    from kubedtn_tpu.api.types import LinkProperties as JProps
    from kubedtn_tpu.api.types import Topology as JTopology
    from kubedtn_tpu.api.types import TopologySpec as JSpec
    from kubedtn_tpu.topology import Reconciler as JReconciler
    from kubedtn_tpu.topology import SimEngine as JEngine
    from kubedtn_tpu.topology import TopologyStore as JStore
    from kubedtn_tpu.wire.server import Daemon as JDaemon

    store = JStore()
    engine = JEngine(store, capacity=16)
    props = JProps(latency="1ms")
    for a, b in (("a", "b"), ("b", "a")):
        store.create(JTopology(name=a, spec=JSpec(links=[
            JLink(local_intf="eth1", peer_intf="eth1", peer_pod=b, uid=1,
                  properties=props)])))
    engine.setup_pod("a")
    engine.setup_pod("b")
    JReconciler(store, engine).drain()
    return JDaemon(engine)


def test_rpc_observers_and_health(served, client):
    pb, c = client.pb, client.c
    h = c.Health(pb.HealthRequest())
    assert h.ok and h.serving and not h.running and h.capacity == 16
    assert h.active_rows == 2 and h.headroom_rows == 14
    # a named plane on a daemon without a federation: this daemon's own
    # health, as the JAX daemon answers (a federation's answer is held
    # in tests/test_torch_fleet.py)
    named = c.Health(pb.HealthRequest(plane="other"))
    want = _jax_daemon().Health(jpb.HealthRequest(plane="other"), None)
    assert named.ok == want.ok is True
    assert named.SerializeToString() == h.SerializeToString()
    assert (named.tenants, named.capacity, named.active_rows) == \
        (want.tenants, want.capacity, want.active_rows)
    links = c.ObserveLinks(pb.ObserveLinksRequest(top_n=5))
    assert not links.ok and "telemetry" in links.error
    assert not c.ObservePauses(pb.ObservePausesRequest()).ok
    assert not c.ObserveTrace(pb.ObserveTraceRequest()).ok


@pytest.mark.parametrize("method,req", [
    ("MigrationStatus", "MigrationStatusRequest"),
    ("MigrateTenant", "MigrateRequest"),
    ("FleetStatus", "FleetStatusRequest"),
    ("FleetUpgrade", "FleetUpgradeRequest")])
def test_rpc_not_ported_answer_unimplemented(served, client, method, req):
    """Every Local RPC is ported. On a daemon without a federation
    controller the migration RPCs, and without a fleet supervisor the
    fleet RPCs, answer the JAX daemon's refusal (the migration itself is
    held in tests/test_torch_federation.py, the fleet in
    tests/test_torch_fleet.py)."""
    if method.startswith("Fleet"):
        resp = getattr(client.c, method)(getattr(client.pb, req)())
        want = getattr(_jax_daemon(), method)(getattr(jpb, req)(), None)
        assert not resp.ok and not want.ok
        assert resp.error == want.error == ("fleet supervision not "
                                            "enabled on this daemon")
        return
    resp = getattr(client.c, method)(getattr(client.pb, req)())
    assert not resp.ok
    assert resp.error == "federation not enabled on this daemon"


@pytest.mark.parametrize("method,req", [
    ("ObserveSLO", "ObserveSLORequest"),
    ("AutopilotCtl", "AutopilotCtlRequest"),
    ("AutopilotStatus", "AutopilotStatusRequest")])
def test_rpc_slo_and_autopilot_refuse_like_jax(client, method, req):
    """On a daemon without a tenancy registry and a telemetry plane
    (ObserveSLO) or without an autopilot (AutopilotCtl/Status), the
    port answers the JAX daemon's refusal, field by field."""
    got = {}
    for pkg in ("port", "jax"):
        _daemon, server, port = _serve_fresh(pkg)
        mod = tclient if client.pb is tpb else jclient
        c = mod.DaemonClient(f"127.0.0.1:{port}")
        try:
            got[pkg] = getattr(c, method)(getattr(client.pb, req)())
        finally:
            c.close()
            server.stop(0)
    assert not got["port"].ok and got["port"].error
    assert got["port"].SerializeToString(deterministic=True) == \
        got["jax"].SerializeToString(deterministic=True)


def test_tenant_rpcs_over_grpc(served, client):
    """Tenant* over the server: without a registry they answer
    ok=False "tenancy not enabled"; with one attached they create,
    list and delete, and Health counts the tenants."""
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    pb, c = client.pb, client.c
    r = c.TenantList(pb.TenantQuery())
    assert not r.ok and "not enabled" in r.error
    daemon = served.daemon
    daemon.tenancy = TenantRegistry(daemon.engine)
    try:
        made = c.TenantCreate(pb.TenantSpec(name="acme", qos="silver",
                                            namespaces=["default"]))
        assert made.ok and made.tenant.qos == "silver"
        assert made.tenant.links == 2 and made.tenant.block_lo == -1
        assert [t.name for t in c.TenantList(pb.TenantQuery()).tenants] \
            == ["acme"]
        assert c.Health(pb.HealthRequest()).tenants == 1
        assert c.TenantDelete(pb.TenantQuery(name="acme")).ok
        assert c.Health(pb.HealthRequest()).tenants == 0
    finally:
        daemon.tenancy = None
        daemon.engine.tenancy = None


def test_grpc_health_service(served):
    """grpc.health.v1 Check, answered from the daemon (the port
    registers the service in its own descriptor pool)."""
    ch = grpc.insecure_channel(f"127.0.0.1:{served.port}")
    check = ch.unary_unary("/grpc.health.v1.Health/Check",
                           request_serializer=lambda b: b,
                           response_deserializer=lambda b: b)
    assert check(b"") == b"\x08\x01"  # status = SERVING
    ch.close()


def test_rpcs_with_plane_attached(served):
    """With a live plane attached, the Observe* surfaces answer from it:
    pauses from its ledger, links and traces once telemetry is on."""
    from kubedtn_tpu_torch.runtime import WireDataPlane

    plane = WireDataPlane(served.daemon, dt_us=1000, pipeline_depth=1)
    plane.enable_telemetry(window_s=10.0, sample_period=1)
    c = tclient.DaemonClient(f"127.0.0.1:{served.port}")
    try:
        w_in = served.daemon._add_wire(types.SimpleNamespace(
            local_pod_name="a", kube_ns="default", link_uid=1,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip=""))
        w_out = served.daemon._add_wire(types.SimpleNamespace(
            local_pod_name="b", kube_ns="default", link_uid=1,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip=""))
        w_in.ingress.extend([b"\x00" * 64] * 4)
        plane.tick(now_s=1.0)
        plane.tick(now_s=1.002)
        assert len(w_out.egress) == 4
        links = c.ObserveLinks(tpb.ObserveLinksRequest(top_n=5))
        assert links.ok and links.links[0].tx == 4.0
        assert c.ObservePauses(tpb.ObservePausesRequest(events=5)).ok
        tr = c.ObserveTrace(tpb.ObserveTraceRequest(limit=50))
        assert tr.ok and tr.sampled == 4 and len(tr.events) > 0
        h = c.Health(tpb.HealthRequest())
        assert h.ok and h.ticks == 2
    finally:
        c.close()
        served.daemon.wires.delete_by_pod("default/a")
        served.daemon.wires.delete_by_pod("default/b")
        served.daemon.dataplane = None
        served.daemon.recorder = None


@pytest.mark.parametrize("module", [
    "kubedtn_tpu_torch.topology.engine", "kubedtn_tpu_torch.runtime",
    "kubedtn_tpu_torch.wire.server", "kubedtn_tpu_torch.topology",
    "kubedtn_tpu_torch.entry"])
def test_import_loads_no_grpc(module):
    """A subprocess: this one has grpc loaded already."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = sorted(m for m in sys.modules if m == 'grpc' or "
            "m.startswith(('grpc.', 'google.protobuf'))); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
