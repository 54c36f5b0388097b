"""Port parity: kubedtn_tpu_torch.topology.k8s against
kubedtn_tpu.topology.k8s, on the CPU.

The JAX package's tests/test_k8s_bridge.py (12 cases: the bridge over an
in-memory duck-typed cluster) and tests/test_http_apiserver.py (9 cases:
HttpKubeApi, HttpLeaseApi and KubeLeaseStore over REAL HTTP against the
port's copy of the protocol-level fake apiserver,
tests/_torch_fake_apiserver.py: chunked JSON-lines watch, 410 as an
ERROR event, merge-patch status and finalizers, Lease CAS) run against
the port. Then the packages against each other: the same event stream
(ADDED / MODIFIED / DELETED and status pushes) leaves equal store
contents, equal bridge counters and equal status patches; both
packages' bridges on one apiserver through a compaction (410) converge
to equal stores; the same CRs through each package's bridge, manager
and engine give equal realized columns.
"""

import copy
import threading
import time

import pytest

from _torch_fake_apiserver import FakeApiServer
from kubedtn_tpu_torch.api.types import (Link, LinkProperties, Topology,
                                         TopologySpec)
from kubedtn_tpu_torch.topology.k8s import (
    ApiHttpError,
    HttpKubeApi,
    HttpLeaseApi,
    K8sBridge,
    K8sUnavailable,
    WatchExpiredError,
    make_kube_api,
)
from kubedtn_tpu_torch.topology.manager import KubeLeaseStore
from kubedtn_tpu_torch.topology.store import NotFoundError, TopologyStore


class FakeClusterApi:
    """Minimal apiserver double for the bridge transport surface. Every
    stored/queued manifest is deep-copied — a real apiserver serializes,
    so objects never share structure with watch events."""

    def __init__(self):
        self.objects: dict[str, dict] = {}
        self.rv = 0
        self.events: list[tuple[str, dict]] = []
        self.status_patches: list[tuple[str, str, dict]] = []

    # -- test helpers --------------------------------------------------
    def put(self, manifest, event="ADDED"):
        import copy

        manifest = copy.deepcopy(manifest)
        self.rv += 1
        manifest.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        key = (manifest["metadata"].get("namespace", "default") + "/"
               + manifest["metadata"]["name"])
        self.objects[key] = manifest
        self.events.append((event, copy.deepcopy(manifest)))

    def remove(self, ns, name):
        key = f"{ns}/{name}"
        manifest = dict(self.objects.pop(key))
        self.rv += 1
        manifest.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        self.events.append(("DELETED", manifest))

    # -- transport surface ---------------------------------------------
    def list_topologies(self):
        return list(self.objects.values()), str(self.rv)

    def watch_topologies(self, resource_version):
        # like the real apiserver: only events newer than the given rv
        since = int(resource_version)
        pending = [e for e in self.events
                   if int(e[1]["metadata"]["resourceVersion"]) > since]
        self.events = []
        yield from pending

    def patch_status(self, ns, name, status):
        import copy

        key = f"{ns}/{name}"
        if key not in self.objects:
            raise NotFoundError(key)
        self.status_patches.append((ns, name, copy.deepcopy(status)))
        self.rv += 1
        obj = copy.deepcopy(self.objects[key])
        obj["status"] = copy.deepcopy(status)
        obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        self.objects[key] = obj
        self.events.append(("MODIFIED", copy.deepcopy(obj)))


def manifest(name, uid=1, peer="r2", latency="10ms"):
    return {
        "apiVersion": "y-young.github.io/v1",
        "kind": "Topology",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"links": [{
            "uid": uid, "local_intf": "eth1", "peer_intf": "eth1",
            "peer_pod": peer, "properties": {"latency": latency},
        }]},
    }


def test_sync_once_seeds_store_and_prunes_stale():
    api = FakeClusterApi()
    api.put(manifest("r1"))
    api.put(manifest("r2", peer="r1"))
    store = TopologyStore()
    store.create(Topology(name="ghost", spec=TopologySpec(links=[])))
    bridge = K8sBridge(store, api)
    assert bridge.sync_once() == 2
    assert {t.name for t in store.list()} == {"r1", "r2"}
    with pytest.raises(NotFoundError):
        store.get("default", "ghost")


def test_watch_pump_applies_spec_changes_and_deletes():
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()

    # spec edit upstream
    m = manifest("r1", latency="50ms")
    api.put(m, event="MODIFIED")
    # a new pod + a deletion
    api.put(manifest("r3", peer="r1"))
    api.remove("default", "r1")
    n = bridge.pump(api.watch_topologies(bridge.cluster_rv))
    assert n == 3
    assert {t.name for t in store.list()} == {"r3"}
    assert bridge.stats["deleted"] == 1


def test_spec_update_preserves_local_status():
    """Cluster owns spec; locally-written status (placement) survives the
    fold-in — the CNI-vs-controller split-writer discipline."""
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()

    t = store.get("default", "r1")
    t.status.src_ip, t.status.net_ns = "10.0.0.5", "/proc/ns/1"
    store.update_status(t)

    api.put(manifest("r1", latency="99ms"), event="MODIFIED")
    bridge.pump(api.watch_topologies(bridge.cluster_rv))
    t2 = store.get("default", "r1")
    assert t2.spec.links[0].properties.latency == "99ms"
    assert t2.status.src_ip == "10.0.0.5"


def test_push_status_and_echo_suppression():
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()

    t = store.get("default", "r1")
    t.status.src_ip, t.status.net_ns = "10.0.0.7", "/proc/ns/2"
    store.update_status(t)
    assert bridge.push_status(store.get("default", "r1"))
    assert api.status_patches and api.status_patches[-1][2]["src_ip"] == \
        "10.0.0.7"
    # identical second push is a no-op
    assert bridge.push_status(store.get("default", "r1"))
    assert len(api.status_patches) == 1
    # the MODIFIED echo from our own patch does not churn the store
    rv_before = store.get("default", "r1").resource_version
    bridge.pump(api.watch_topologies(bridge.cluster_rv))
    assert bridge.stats["echoes_skipped"] == 1
    assert store.get("default", "r1").resource_version == rv_before


def test_bridge_drives_engine_end_to_end():
    """Cluster events -> store -> reconciler -> device arrays, with the
    status pushed back: the reference's controller+informer loop shape."""
    from kubedtn_tpu_torch.topology import Reconciler, SimEngine

    api = FakeClusterApi()
    api.put(manifest("r1", peer="r2"))
    api.put(manifest("r2", peer="r1"))
    store = TopologyStore()
    engine = SimEngine(store, device="cpu")
    rec = Reconciler(store, engine)
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    for name in ("r1", "r2"):
        engine.setup_pod(name)
    rec.drain()
    assert engine.num_active == 2
    for t in store.list():
        assert bridge.push_status(t)
    assert len(api.status_patches) == 2

    # upstream latency change flows through to the device row
    api.put(manifest("r1", peer="r2", latency="77ms"), event="MODIFIED")
    bridge.pump(api.watch_topologies(bridge.cluster_rv))
    rec.drain()
    row = engine.link_row("default/r1", 1)
    assert row["latency_us"] == 77_000


def test_real_client_gated():
    with pytest.raises(K8sUnavailable):
        make_kube_api()


def test_foreign_status_write_does_not_churn_store():
    """A status-only MODIFIED from ANOTHER writer (not in our pushed
    cache) must not bump the store rv / re-trigger reconciliation."""
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    rv_before = store.get("default", "r1").resource_version

    peer_view = dict(api.objects["default/r1"])
    peer_view["status"] = {"src_ip": "10.9.9.9", "net_ns": "/proc/ns/77"}
    api.put(peer_view, event="MODIFIED")
    bridge.pump(api.watch_topologies(bridge.cluster_rv))
    assert store.get("default", "r1").resource_version == rv_before


def test_push_status_transient_error_propagates_not_false():
    """A network blip must not read as 'object deleted' (False)."""
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    t = store.get("default", "r1")
    t.status.src_ip, t.status.net_ns = "1.2.3.4", "/ns"
    store.update_status(t)

    boom = RuntimeError("apiserver 500")
    api.patch_status_orig = api.patch_status
    api.patch_status = lambda *a: (_ for _ in ()).throw(boom)
    with pytest.raises(RuntimeError):
        bridge.push_status(store.get("default", "r1"))
    api.patch_status = api.patch_status_orig
    assert bridge.push_status(store.get("default", "r1"))
    # vanished upstream: False, not an exception
    api.remove("default", "r1")
    t.status.src_ip = "5.6.7.8"
    assert bridge.push_status(t) is False


def test_finalizer_patch_failure_keeps_echo_suppression():
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    t = store.get("default", "r1")
    t.status.src_ip, t.status.net_ns = "1.1.1.1", "/ns"
    t.finalizers = ["kubedtn"]
    store.update_status(t)

    api.patch_finalizers = lambda *a: (_ for _ in ()).throw(
        RuntimeError("transient"))
    with pytest.raises(RuntimeError):
        bridge.push_status(store.get("default", "r1"))
    # the status DID land; its echo must still be suppressed
    rv_before = store.get("default", "r1").resource_version
    bridge.pump(api.watch_topologies(bridge.cluster_rv))
    assert bridge.stats["echoes_skipped"] == 1
    assert store.get("default", "r1").resource_version == rv_before


def test_restarted_informer_gets_fresh_stop_event():
    """A predecessor thread wedged in a watch must stay stopped: each
    start() binds a new stop event, never un-stopping the old thread."""
    import threading

    api = FakeClusterApi()
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    release = threading.Event()

    def blocking_watch(rv):
        release.wait(10)
        return iter(())

    api.watch_topologies = blocking_watch
    bridge.start()
    ev1 = bridge._stop
    bridge.stop()            # join times out? no — watch returns on release
    assert ev1.is_set()
    bridge.start()
    assert bridge._stop is not ev1 and not bridge._stop.is_set()
    release.set()
    bridge.stop()


def test_sync_once_gc_scoped_to_transport_namespace():
    """Regression: a namespace-scoped LIST says nothing about other
    namespaces — resync GC must not delete store objects outside the
    transport's scope."""
    api = FakeClusterApi()
    api.namespace = "scoped"          # transport advertises its scope
    m = manifest("r1")
    m["metadata"]["namespace"] = "scoped"
    api.put(m)
    store = TopologyStore()
    store.create(Topology(name="other", namespace="default",
                          spec=TopologySpec(links=[])))
    # stale object INSIDE the scope: still GCed
    store.create(Topology(name="gone", namespace="scoped",
                          spec=TopologySpec(links=[])))
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    assert store.get("scoped", "r1") is not None
    assert store.get("default", "other") is not None   # survived the resync
    with pytest.raises(NotFoundError):
        store.get("scoped", "gone")


def test_sync_once_gc_cluster_scoped_unchanged():
    """Without a namespace attribute the transport is cluster-scoped and
    GC covers everything, as before."""
    api = FakeClusterApi()
    api.put(manifest("r1"))
    store = TopologyStore()
    store.create(Topology(name="stale", namespace="elsewhere",
                          spec=TopologySpec(links=[])))
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    with pytest.raises(NotFoundError):
        store.get("elsewhere", "stale")


# -- over real HTTP (tests/test_http_apiserver.py) --------------------




def http_manifest(name: str, latency: str = "10ms", ns: str = "default",
                  uid: int = 1) -> dict:
    t = Topology(name=name, namespace=ns, spec=TopologySpec(links=[
        Link(local_intf="eth1", peer_intf="eth1", peer_pod="peer",
             uid=uid, properties=LinkProperties(latency=latency))]))
    return t.to_manifest()


@pytest.fixture()
def server():
    # the server ends each watch after 1 s (the JAX tests' fixture: 5 s):
    # the informer re-watches from its last version either way, and a
    # stopped informer's thread leaves within that second
    srv = FakeApiServer(event_window=16, watch_timeout_s=1.0)
    host, port = srv.start()
    yield srv, f"http://{host}:{port}"
    srv.stop()


def test_list_and_get_over_http(server):
    srv, url = server
    srv.put_object(http_manifest("r1"))
    srv.put_object(http_manifest("r2", ns="other"))
    api = HttpKubeApi(url)
    items, rv = api.list_topologies()
    assert {i["metadata"]["name"] for i in items} == {"r1", "r2"}
    assert int(rv) >= 2
    api_ns = HttpKubeApi(url, namespace="other")
    items, _ = api_ns.list_topologies()
    assert [i["metadata"]["name"] for i in items] == ["r2"]


def test_watch_streams_chunked_events(server):
    srv, url = server
    api = HttpKubeApi(url, timeout_s=10.0)
    _, rv = api.list_topologies()
    got = []

    def watcher():
        for ev_type, obj in api.watch_topologies(rv):
            got.append((ev_type, obj["metadata"]["name"]))
            if len(got) >= 3:
                return

    t = threading.Thread(target=watcher, daemon=True)
    t.start()
    time.sleep(0.2)
    srv.put_object(http_manifest("a"))
    srv.put_object(http_manifest("a", latency="50ms"))
    srv.delete_object("default", "a")
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [("ADDED", "a"), ("MODIFIED", "a"), ("DELETED", "a")]


def test_watch_expired_raises_410(server):
    srv, url = server
    api = HttpKubeApi(url)
    srv.put_object(http_manifest("r1"))
    _, rv = api.list_topologies()
    # push the retained window past rv, then compact
    for i in range(20):
        srv.put_object(http_manifest("r1", latency=f"{i + 1}ms"))
    srv.expire_history()
    with pytest.raises(WatchExpiredError):
        for _ in api.watch_topologies(rv):
            pass


def test_status_patch_roundtrip_over_http(server):
    srv, url = server
    srv.put_object(http_manifest("r1"))
    api = HttpKubeApi(url)
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.sync_once()
    t = store.get("default", "r1")
    t.status.src_ip = "10.9.9.9"
    t.status.net_ns = "/proc/42/ns/net"
    store.update_status(t)
    assert bridge.push_status(store.get("default", "r1")) is True
    obj = srv.objects[("default", "r1")]
    assert obj["status"]["src_ip"] == "10.9.9.9"
    # PATCH went to the status subresource, not the object
    assert any(p.endswith("/r1/status") and p.startswith("PATCH")
               for p in srv.requests)
    # vanished object reads as False (404), not an exception
    srv.delete_object("default", "r1")
    t.status.src_ip = "10.0.0.1"
    assert bridge.push_status(t) is False


def test_informer_relists_immediately_on_410(server):
    srv, url = server
    api = HttpKubeApi(url, timeout_s=10.0)
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    errors: list[Exception] = []
    stop = threading.Event()
    th = threading.Thread(
        target=lambda: bridge.run(on_error=errors.append, stop=stop),
        daemon=True)
    srv.put_object(http_manifest("r1"))
    th.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not store.list():
        time.sleep(0.05)
    assert [t.name for t in store.list()] == ["r1"]

    # expire the watch history while more changes land
    srv.expire_history()
    srv.put_object(http_manifest("r2"))
    t0 = time.monotonic()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(store.list()) < 2:
        time.sleep(0.05)
    recovery_s = time.monotonic() - t0
    assert {t.name for t in store.list()} == {"r1", "r2"}
    # 410 recovery is an immediate re-list: well under the 1s the old
    # fixed sleep imposed, and the error surfaced to on_error
    assert recovery_s < 1.0, f"410 recovery took {recovery_s:.2f}s"
    assert any(getattr(e, "status", None) == 410 or
               isinstance(e, WatchExpiredError) for e in errors)
    n_lists = sum(1 for p in srv.requests
                  if p.startswith("GET") and "watch" not in p
                  and p.endswith("/topologies"))
    assert n_lists >= 2  # initial + post-410
    stop.set()
    th.join(timeout=10)


def test_informer_backs_off_on_transient_and_resumes_without_list(server):
    srv, url = server

    class CountingApi(HttpKubeApi):
        lists = 0
        watch_fail = 0

        def list_topologies(self):
            type(self).lists += 1
            return super().list_topologies()

        def watch_topologies(self, rv):
            if type(self).watch_fail > 0:
                type(self).watch_fail -= 1
                raise ConnectionResetError("transient blip")
            yield from super().watch_topologies(rv)

    CountingApi.lists = 0
    CountingApi.watch_fail = 2
    api = CountingApi(url, timeout_s=10.0)
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    bridge.BACKOFF_INITIAL_S = 0.05  # keep the test fast
    errors: list[Exception] = []
    stop = threading.Event()
    srv.put_object(http_manifest("r1"))
    th = threading.Thread(
        target=lambda: bridge.run(on_error=errors.append, stop=stop),
        daemon=True)
    th.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not store.list():
        time.sleep(0.05)
    # both transient failures burned, watch established
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and CountingApi.watch_fail > 0:
        time.sleep(0.05)
    srv.put_object(http_manifest("r2"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and len(store.list()) < 2:
        time.sleep(0.05)
    assert {t.name for t in store.list()} == {"r1", "r2"}
    # transient errors resumed from the last RV: exactly ONE list
    assert CountingApi.lists == 1, f"{CountingApi.lists} LISTs"
    assert len(errors) >= 2
    stop.set()
    th.join(timeout=10)


def test_bridge_spec_sync_full_loop_over_http(server):
    """spec change on the 'cluster' flows to the store via the watch;
    local status flows back via the subresource; the echo of our own
    status push is suppressed."""
    srv, url = server
    api = HttpKubeApi(url, timeout_s=10.0)
    store = TopologyStore()
    bridge = K8sBridge(store, api)
    stop = threading.Event()
    srv.put_object(http_manifest("r1", latency="10ms"))
    th = threading.Thread(target=lambda: bridge.run(stop=stop),
                          daemon=True)
    th.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not store.list():
        time.sleep(0.05)

    srv.put_object(http_manifest("r1", latency="99ms"))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            t = store.get("default", "r1")
            if t.spec.links[0].properties.latency == "99ms":
                break
        except Exception:
            pass
        time.sleep(0.05)
    assert store.get("default", "r1").spec.links[0] \
        .properties.latency == "99ms"

    t = store.get("default", "r1")
    t.status.src_ip = "10.1.2.3"
    store.update_status(t)
    assert bridge.push_status(store.get("default", "r1"))
    time.sleep(0.5)  # let the echo event arrive
    assert srv.objects[("default", "r1")]["status"]["src_ip"] == "10.1.2.3"
    assert bridge.stats["echoes_skipped"] >= 1
    stop.set()
    th.join(timeout=10)


def test_kube_lease_store_cas_over_http(server):
    srv, url = server
    api = HttpLeaseApi(url)
    a = KubeLeaseStore(namespace="kubedtn-tpu", api=api)
    b = KubeLeaseStore(namespace="kubedtn-tpu", api=api)
    assert a.try_acquire("leader", "pod-a", 0.0, 2.0) is True
    assert b.try_acquire("leader", "pod-b", 0.0, 2.0) is False
    assert b.holder("leader") == "pod-a"
    # renewal by the holder succeeds (CAS against current RV)
    assert a.try_acquire("leader", "pod-a", 0.0, 2.0) is True
    # release → immediate takeover
    a.release("leader", "pod-a")
    assert b.try_acquire("leader", "pod-b", 0.0, 2.0) is True
    assert a.holder("leader") == "pod-b"
    lease = srv.leases[("kubedtn-tpu", "leader")]
    assert lease["spec"]["holderIdentity"] == "pod-b"

    # a STALE (unreleased) holder is stolen, and that counts a transition
    t = {"now": time.time()}
    c = KubeLeaseStore(namespace="steal", api=api, clock=lambda: t["now"])
    assert c.try_acquire("l2", "pod-a", 0.0, 2.0) is True
    t["now"] += 10.0  # lease duration elapsed without renewal
    d = KubeLeaseStore(namespace="steal", api=api, clock=lambda: t["now"])
    assert d.try_acquire("l2", "pod-b", 0.0, 2.0) is True
    assert srv.leases[("steal", "l2")]["spec"]["leaseTransitions"] == 1


def test_lease_stale_rv_put_conflicts(server):
    srv, url = server
    api = HttpLeaseApi(url)
    store = KubeLeaseStore(namespace="ns", api=api)
    assert store.try_acquire("l", "a", 0.0, 30.0)
    lease = api.read_namespaced_lease("l", "ns")
    # another writer bumps the RV behind our back
    lease2 = dict(lease)
    lease2["spec"] = dict(lease["spec"], holderIdentity="b")
    api.replace_namespaced_lease("l", "ns", lease2)
    # replaying the FIRST lease body (stale RV) must 409
    with pytest.raises(ApiHttpError) as ei:
        api.replace_namespaced_lease("l", "ns", lease)
    assert ei.value.status == 409


# -- the packages against each other ----------------------------------------

class _Gone(Exception):
    status = 404


class AgnosticClusterApi(FakeClusterApi):
    """FakeClusterApi answering a patch of a vanished object with a
    404-status error, which either package's bridge reads as gone."""

    def patch_status(self, ns, name, status):
        if f"{ns}/{name}" not in self.objects:
            raise _Gone(f"{ns}/{name}")
        super().patch_status(ns, name, status)


def pkg(name):
    """(types, store, k8s) modules of one package."""
    import importlib

    root = {"jax": "kubedtn_tpu", "torch": "kubedtn_tpu_torch"}[name]
    return (importlib.import_module(f"{root}.api.types"),
            importlib.import_module(f"{root}.topology.store"),
            importlib.import_module(f"{root}.topology.k8s"))


def store_view(store, with_rv=True) -> list:
    out = []
    for t in sorted(store.list(), key=lambda t: t.key):
        m = t.to_manifest()
        if not with_rv:
            m["metadata"].pop("resourceVersion", None)
        out.append((t.key, m, t.resource_version if with_rv else None))
    return out


def drive_event_stream(name) -> dict:
    """One scripted cluster history through one package's bridge: the
    initial LIST, spec edits, a create, a delete, local status pushed
    (echoes suppressed), a foreign status write, an identical push, a
    push after the object vanished upstream."""
    types_, st, k8s = pkg(name)
    api = AgnosticClusterApi()
    for n, peer in (("r1", "r2"), ("r2", "r1"), ("r3", "r1")):
        api.put(manifest(n, uid=int(n[1]), peer=peer))
    store = st.TopologyStore()
    bridge = k8s.K8sBridge(store, api)
    steps = [bridge.sync_once()]
    api.put(manifest("r1", uid=1, peer="r2", latency="50ms"),
            event="MODIFIED")
    api.remove("default", "r2")
    api.put(manifest("r4", uid=4, peer="r3"))
    steps.append(bridge.pump(api.watch_topologies(bridge.cluster_rv)))
    pushed = []
    for n, ip in (("r1", "10.0.0.5"), ("r3", "10.0.0.6")):
        t = store.get("default", n)
        t.status.src_ip, t.status.net_ns = ip, f"/proc/{n}/ns/net"
        t.finalizers = ["y-young.github.io/v1"]
        store.update_status(t)
        pushed.append(bridge.push_status(store.get("default", n)))
    steps.append(bridge.pump(api.watch_topologies(bridge.cluster_rv)))
    foreign = copy.deepcopy(api.objects["default/r4"])
    foreign["status"] = {"src_ip": "10.9.9.9", "net_ns": "/proc/77"}
    api.put(foreign, event="MODIFIED")
    steps.append(bridge.pump(api.watch_topologies(bridge.cluster_rv)))
    pushed.append(bridge.push_status(store.get("default", "r1")))
    api.remove("default", "r3")
    t = store.get("default", "r3")
    t.status.src_ip = "10.0.0.7"
    pushed.append(bridge.push_status(t))
    steps.append(bridge.pump(api.watch_topologies(bridge.cluster_rv)))
    return {"store": store_view(store), "stats": dict(bridge.stats),
            "patches": api.status_patches, "pushed": pushed,
            "steps": steps, "cluster_rv": bridge.cluster_rv}


def test_same_event_stream_equal_stores_and_patches_jax_vs_port():
    """The same event stream leaves equal store contents (manifests and
    resource versions), bridge counters, status patches and verdicts in
    both packages."""
    want, got = drive_event_stream("jax"), drive_event_stream("torch")
    assert got == want
    assert got["pushed"] == [True, True, True, False]
    assert got["stats"]["echoes_skipped"] >= 2


def wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_410_relist_converges_jax_vs_port():
    """Both packages' informers on one apiserver through a compaction:
    each relists at once (a 410 reaches on_error) and both stores end
    with the same objects, specs and statuses."""
    srv = FakeApiServer(event_window=16, watch_timeout_s=1.0)
    host, port = srv.start()
    url = f"http://{host}:{port}"
    runs = {}
    try:
        srv.put_object(http_manifest("r1"))
        srv.put_object(http_manifest("r2", ns="other", uid=2))
        for name in ("jax", "torch"):
            _types, st, k8s = pkg(name)
            store = st.TopologyStore()
            bridge = k8s.K8sBridge(store, k8s.HttpKubeApi(url,
                                                          timeout_s=10.0))
            errors, stop = [], threading.Event()
            th = threading.Thread(target=lambda b=bridge, e=errors, s=stop:
                                  b.run(on_error=e.append, stop=s),
                                  daemon=True)
            th.start()
            runs[name] = (store, errors, stop, th)

        def converged(n):
            return all(len(r[0].list()) == n for r in runs.values())

        assert wait_until(lambda: converged(2))
        srv.expire_history()
        srv.put_object(http_manifest("r3", uid=3))
        srv.put_object(http_manifest("r1", latency="77ms"))
        srv.delete_object("other", "r2")
        assert wait_until(lambda: converged(2) and all(
            {t.name for t in r[0].list()} == {"r1", "r3"}
            and r[0].get("default", "r1").spec.links[0].properties.latency
            == "77ms" for r in runs.values()))
        for store, errors, _stop, _th in runs.values():
            assert any(getattr(e, "status", None) == 410 for e in errors)
        assert store_view(runs["torch"][0], with_rv=False) == \
            store_view(runs["jax"][0], with_rv=False)
    finally:
        for _store, _errors, stop, th in runs.values():
            stop.set()
            th.join(timeout=10)
        srv.stop()


def test_bridge_and_manager_equal_realized_columns_jax_vs_port():
    """The same CRs (the 4 x 10 Clos, placed) on the apiserver through
    each package's bridge, ControllerManager and engine: equal realized
    columns, row for row; every status pushed back lands on the
    apiserver equal; a spec edit through the watch reaches both
    engines' rows alike."""
    import importlib

    from test_torch_manager import (assert_same_realized, clos_manifests,
                                    engine_kw)

    srv = FakeApiServer(event_window=4096, watch_timeout_s=1.0)
    host, port = srv.start()
    url = f"http://{host}:{port}"
    for m in clos_manifests():
        srv.put_object(m)
    sides = {}
    try:
        for name in ("jax", "torch"):
            _types, st, k8s = pkg(name)
            root = k8s.__name__.rsplit(".", 2)[0]
            topo = importlib.import_module(f"{root}.topology")
            man = importlib.import_module(f"{root}.topology.manager")
            store = st.TopologyStore()
            engine = topo.SimEngine(store, **engine_kw(name, 128))
            bridge = k8s.K8sBridge(store, k8s.HttpKubeApi(url,
                                                          timeout_s=10.0))
            bridge.sync_once()
            mgr = man.ControllerManager(store, engine, identity=name,
                                        workers=1)
            mgr.start()
            bridge.start()
            sides[name] = (store, engine, bridge, mgr)
        for store, engine, bridge, mgr in sides.values():
            assert wait_until(lambda: mgr.status.synced
                              and engine.num_active == 80)
        assert_same_realized(sides["jax"][1], sides["torch"][1],
                             exact_rows=True)
        statuses = {}
        for name, (store, _e, bridge, _m) in sides.items():
            assert all(bridge.push_status(t) for t in store.list())
            statuses[name] = {k: o.get("status")
                              for k, o in sorted(srv.objects.items())}
        assert statuses["torch"] == statuses["jax"]
        leaf = srv.objects[("default", "leaf3")]
        edit = copy.deepcopy(leaf)
        for l in edit["spec"]["links"]:
            l["properties"] = {"latency": "3ms", "rate": "1Gbit"}
        srv.put_object(edit)
        for store, engine, _b, _m in sides.values():
            assert wait_until(lambda: engine.link_row(
                "default/leaf3", edit["spec"]["links"][0]["uid"])
                ["latency_us"] == 3000.0)
        for store, _e, _b, mgr in sides.values():
            assert wait_until(lambda: store.get("default", "leaf3")
                              .status.links == store.get(
                                  "default", "leaf3").spec.links)
        assert_same_realized(sides["jax"][1], sides["torch"][1],
                             exact_rows=True)
    finally:
        for _s, _e, bridge, mgr in sides.values():
            mgr.stop()
            bridge.stop()
        srv.stop()
