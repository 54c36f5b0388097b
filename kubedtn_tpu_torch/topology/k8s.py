"""K8s bridge — sync Topology CRs between a real cluster and the store.

The reference talks to the Kubernetes API in two ways: a hand-rolled typed
clientset (reference api/clientset/v1beta1/topology.go:32-188 — List/Get/
Watch/Update/UpdateStatus against group y-young.github.io) and a shared
informer feeding the daemon's cache (reference daemon/kubedtn/kubedtn.go:
128-142). Here the in-process :class:`TopologyStore` plays the apiserver
role for standalone runs; this module is the optional bridge that keeps the
store in sync with a REAL cluster when one exists, so the same reconciler/
engine stack runs unmodified either way:

- cluster → store: initial LIST then a WATCH pump applies ADDED/MODIFIED/
  DELETED spec changes into the store (the informer direction);
- store → cluster: status written locally by the daemon/reconciler (the
  placement + applied-links subresource, reference handler.go:90-147) is
  pushed back via the status subresource endpoint (the clientset
  UpdateStatus direction, topology.go:171-184); a vanished object reads
  as False, transient API errors propagate to the caller's retry loop.

The real-cluster transport is duck-typed (`list_topologies`,
`watch_topologies`, `patch_status`, `patch_finalizers`): production wraps
the `kubernetes` package's CustomObjectsApi (gated import — raises
:class:`K8sUnavailable` when the package is missing, which it is in this
image), and the test suite drives the same bridge with an in-memory fake
cluster, mirroring how the reference tests controllers against envtest
(reference controllers/suite_test.go:44-80).

Port of kubedtn_tpu/topology/k8s.py: the same transports, bridge and
informer loop over the port's TopologyStore. No kubernetes client is
needed for HttpKubeApi / HttpLeaseApi; make_kube_api stays gated. The
bridge reads an object's key from its metadata instead of parsing the
whole manifest twice, and its echo check reuses the spec manifest of the
push it echoes while the store's object holds that push's Links: the
same decisions, without re-serialising a 1000-link CR per event.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable

from kubedtn_tpu_torch import GROUP, VERSION
from kubedtn_tpu_torch.api.types import Topology
from kubedtn_tpu_torch.topology.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    TopologyStore,
    retry_on_conflict,
)

PLURAL = "topologies"


class K8sUnavailable(RuntimeError):
    """The kubernetes client package is not importable."""


class WatchExpiredError(RuntimeError):
    """The watch's resourceVersion fell out of the apiserver's retained
    window (HTTP 410 Gone / an ERROR event with code 410). Recovery is a
    fresh LIST — NOT a backoff-resume, which would 410 forever."""

    status = 410


class ApiHttpError(RuntimeError):
    """Non-2xx from the HTTP transport; `.status` carries the code so the
    bridge's 404/409/410 handling works like the kubernetes client's
    ApiException."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class HttpKubeApi:
    """The bridge transport over the RAW Kubernetes REST protocol — no
    `kubernetes` package needed. Point it at any endpoint speaking the
    CustomObjects surface: `kubectl proxy` (http://127.0.0.1:8001) in
    production, the test suite's protocol-level fake apiserver
    (tests/_torch_fake_apiserver.py, the envtest role of reference
    controllers/suite_test.go:44-80) in CI.

    Implements the duck-typed surface K8sBridge expects
    (list_topologies / watch_topologies / patch_status /
    patch_finalizers). Watch streams JSON-lines events; an ERROR event
    carrying code 410 raises WatchExpiredError so the informer loop
    re-lists instead of resuming.
    """

    def __init__(self, base_url: str, namespace: str | None = None,
                 timeout_s: float = 30.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace
        self.timeout_s = timeout_s

    # -- plumbing ------------------------------------------------------

    def _collection_path(self) -> str:
        if self.namespace is None:
            return f"/apis/{GROUP}/{VERSION}/{PLURAL}"
        return (f"/apis/{GROUP}/{VERSION}/namespaces/"
                f"{self.namespace}/{PLURAL}")

    def _object_path(self, ns: str, name: str, sub: str = "") -> str:
        p = f"/apis/{GROUP}/{VERSION}/namespaces/{ns}/{PLURAL}/{name}"
        return p + (f"/{sub}" if sub else "")

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json",
                 parse: bool = True) -> dict:
        """The answer's JSON (read in full, parsed only with `parse`: a
        PATCH's caller has no use for the object it echoes)."""
        import json as _json
        import urllib.error
        import urllib.request

        data = _json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": content_type} if data else {})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                raw = resp.read()
                return _json.loads(raw or b"{}") if parse else {}
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise ApiHttpError(e.code, detail) from e

    # -- bridge surface ------------------------------------------------

    def list_topologies(self) -> tuple[list[dict], str]:
        r = self._request("GET", self._collection_path())
        return r.get("items", []), r["metadata"]["resourceVersion"]

    def watch_topologies(self, resource_version: str):
        import json as _json
        import socket
        import urllib.request

        url = (f"{self.base_url}{self._collection_path()}"
               f"?watch=true&resourceVersion={resource_version}")
        req = urllib.request.Request(url)
        # a connect failure IS a transient error and propagates; but once
        # the stream is up, a read timeout just means the cluster was
        # idle for timeout_s — that's an orderly end of stream (client-go
        # re-watches immediately), NOT a failure to back off from
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            while True:
                try:
                    raw = resp.readline()
                except (TimeoutError, socket.timeout):
                    return  # idle stream: caller re-watches from last RV
                if not raw:
                    return  # server closed the stream
                raw = raw.strip()
                if not raw:
                    continue
                ev = _json.loads(raw)
                if ev.get("type") == "ERROR":
                    code = ev.get("object", {}).get("code")
                    if code == 410:
                        raise WatchExpiredError(
                            ev["object"].get("message", "expired"))
                    raise ApiHttpError(code or 500,
                                       ev["object"].get("message", ""))
                yield ev["type"], ev["object"]

    def patch_status(self, ns: str, name: str, status: dict) -> None:
        self._request("PATCH", self._object_path(ns, name, "status"),
                      {"status": status},
                      content_type="application/merge-patch+json",
                      parse=False)

    def patch_finalizers(self, ns: str, name: str,
                         finalizers: list[str]) -> None:
        self._request("PATCH", self._object_path(ns, name),
                      {"metadata": {"finalizers": finalizers}},
                      content_type="application/merge-patch+json",
                      parse=False)


class HttpLeaseApi:
    """coordination.k8s.io/v1 Leases over raw HTTP, shaped like the
    kubernetes CoordinationV1Api surface KubeLeaseStore injects
    (read/create/replace_namespaced_lease returning dict manifests) —
    real cross-pod leader election through `kubectl proxy` or the test
    fake, with the apiserver's resourceVersion CAS intact (a PUT with a
    stale RV answers 409, which KubeLeaseStore reads as a lost
    election)."""

    def __init__(self, base_url: str, timeout_s: float = 10.0) -> None:
        self._api = HttpKubeApi(base_url, timeout_s=timeout_s)

    @staticmethod
    def _path(ns: str, name: str = "") -> str:
        p = f"/apis/coordination.k8s.io/v1/namespaces/{ns}/leases"
        return p + (f"/{name}" if name else "")

    def read_namespaced_lease(self, name: str, namespace: str) -> dict:
        return self._api._request("GET", self._path(namespace, name))

    def create_namespaced_lease(self, namespace: str, body: dict) -> dict:
        return self._api._request("POST", self._path(namespace), body)

    def replace_namespaced_lease(self, name: str, namespace: str,
                                 body: dict) -> dict:
        return self._api._request("PUT", self._path(namespace, name),
                                  body)


def make_kube_api(namespace: str | None = None):
    """Wrap the real `kubernetes` package into the bridge's transport
    surface. Raises K8sUnavailable when the package is absent (it is not
    baked into this image; standalone mode needs no cluster)."""
    try:
        import kubernetes  # type: ignore
    except ImportError as e:
        raise K8sUnavailable(
            "the 'kubernetes' package is not installed; run standalone "
            "(TopologyStore) or install the client") from e

    try:
        kubernetes.config.load_incluster_config()
    except kubernetes.config.config_exception.ConfigException:
        try:  # out-of-cluster operator: fall back to kubeconfig
            kubernetes.config.load_kube_config()
        except kubernetes.config.config_exception.ConfigException as e:
            raise K8sUnavailable(
                "no in-cluster service account and no kubeconfig") from e
    api = kubernetes.client.CustomObjectsApi()

    class _Api:
        def list_topologies(self) -> tuple[list[dict], str]:
            r = api.list_cluster_custom_object(GROUP, VERSION, PLURAL) \
                if namespace is None else api.list_namespaced_custom_object(
                    GROUP, VERSION, namespace, PLURAL)
            return r.get("items", []), r["metadata"]["resourceVersion"]

        def watch_topologies(self, resource_version: str):
            w = kubernetes.watch.Watch()
            kwargs = dict(resource_version=resource_version)
            if namespace is None:
                stream = w.stream(api.list_cluster_custom_object, GROUP,
                                  VERSION, PLURAL, **kwargs)
            else:
                stream = w.stream(api.list_namespaced_custom_object, GROUP,
                                  VERSION, namespace, PLURAL, **kwargs)
            for ev in stream:
                yield ev["type"], ev["object"]

        def patch_status(self, ns: str, name: str, status: dict) -> None:
            api.patch_namespaced_custom_object_status(
                GROUP, VERSION, ns, PLURAL, name, {"status": status})

        def patch_finalizers(self, ns: str, name: str,
                             finalizers: list[str]) -> None:
            api.patch_namespaced_custom_object(
                GROUP, VERSION, ns, PLURAL, name,
                {"metadata": {"finalizers": finalizers}})

    wrapped = _Api()
    # advertise the scope so K8sBridge.sync_once GCs only inside it
    wrapped.namespace = namespace
    return wrapped


class K8sBridge:
    """Bidirectional sync between a cluster transport and a TopologyStore."""

    def __init__(self, store: TopologyStore, api: Any) -> None:
        self.store = store
        self.api = api
        self.cluster_rv: str = "0"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # last status manifest pushed per key, to break the push→watch echo
        self._pushed_status: dict[str, dict] = {}
        # per key, the links and the spec manifest of that push: the echo
        # check's fast path (see _spec_manifest)
        self._pushed_spec: dict[str, tuple[list, dict]] = {}
        self.stats = {"applied": 0, "deleted": 0, "status_pushed": 0,
                      "echoes_skipped": 0, "conflicts": 0}

    # -- cluster → store ----------------------------------------------

    def sync_once(self) -> int:
        """Initial LIST: seed/refresh every cluster object into the store
        (the informer's initial sync). Returns the object count."""
        items, rv = self.api.list_topologies()
        self.cluster_rv = rv
        seen = set()
        for manifest in items:
            seen.add(self._apply(manifest))
        # Objects gone from the cluster while we were away. GC only within
        # the transport's visibility: a namespace-scoped LIST says nothing
        # about other namespaces, so deleting store objects outside its
        # scope would wrongly wipe them on every resync.
        scope = getattr(self.api, "namespace", None)
        for t in self.store.list(scope):
            if t.key not in seen:
                self._delete(t.namespace, t.name)
        return len(items)

    def pump(self, events: Iterable[tuple[str, dict]]) -> int:
        """Apply a batch of (type, manifest) watch events. Returns the
        number applied."""
        n = 0
        for ev_type, manifest in events:
            if ev_type in ("ADDED", "MODIFIED"):
                self._apply(manifest)
            elif ev_type == "DELETED":
                meta = manifest.get("metadata", {})
                self._delete(meta.get("namespace", "default"), meta["name"])
            rv = manifest.get("metadata", {}).get("resourceVersion")
            if rv is not None:
                self.cluster_rv = rv
            n += 1
        return n

    @staticmethod
    def _key_of(manifest: dict) -> tuple[str, str, str]:
        """(namespace, name, key) as Topology.from_manifest reads them."""
        meta = manifest.get("metadata", {})
        ns, name = meta.get("namespace", "default"), meta["name"]
        return ns, name, f"{ns}/{name}"

    def _spec_manifest(self, current: Topology) -> dict | None:
        """current.to_manifest()["spec"]. When the store's object still
        holds the very Link objects of our last push (Links are immutable
        and shared by the store's clones), that push's spec manifest is
        it, and no 1000-link CR is serialised again per echo."""
        hit = self._pushed_spec.get(current.key)
        if hit is not None:
            links, spec = hit
            cur = current.spec.links
            if len(links) == len(cur) and all(
                    a is b for a, b in zip(links, cur)):
                return spec
        return current.to_manifest().get("spec")

    def _apply(self, manifest: dict) -> str:
        """Fold one cluster object into the store; returns its key."""
        ns, name, key = self._key_of(manifest)

        # echo of our own status push? spec-identical + status we just
        # wrote ⇒ nothing to fold back into the store
        pushed = self._pushed_status.get(key)
        if pushed is not None and manifest.get("status") == pushed:
            try:
                current = self.store.get(ns, name)
            except NotFoundError:
                current = None
            if current is not None and \
                    self._spec_manifest(current) == manifest.get("spec"):
                self.stats["echoes_skipped"] += 1
                return key
        incoming = Topology.from_manifest(manifest)

        def txn():
            try:
                current = self.store.get(incoming.namespace, incoming.name)
            except NotFoundError:
                try:
                    self.store.create(incoming)
                except AlreadyExistsError:
                    raise ConflictError(incoming.key)
                return
            # status-only change by another writer: nothing to fold in —
            # bumping the store rv here would re-trigger reconciliation
            # cluster-wide on every peer's status write
            if current.spec == incoming.spec:
                return
            # cluster owns the spec; local owners keep writing status
            current.spec = incoming.spec
            self.store.update(current)

        try:
            retry_on_conflict(txn)
            self.stats["applied"] += 1
        except ConflictError:
            self.stats["conflicts"] += 1
        return key

    def _delete(self, ns: str, name: str) -> None:
        try:
            self.store.delete(ns, name)
            self.stats["deleted"] += 1
        except NotFoundError:
            pass
        self._pushed_status.pop(f"{ns}/{name}", None)
        self._pushed_spec.pop(f"{ns}/{name}", None)

    # -- store → cluster ----------------------------------------------

    @staticmethod
    def _is_not_found(e: Exception) -> bool:
        return isinstance(e, NotFoundError) or \
            getattr(e, "status", None) == 404

    def push_status(self, topology: Topology) -> bool:
        """Write a locally-updated status (placement/applied links) to the
        cluster's status subresource — the clientset UpdateStatus
        direction. Returns False when the object vanished upstream (404);
        any other API error propagates so the caller's loop can retry —
        a transient failure must not read as deletion."""
        manifest = topology.to_manifest()
        status = manifest.get("status", {})
        if self._pushed_status.get(topology.key) == status:
            return True
        try:
            self.api.patch_status(topology.namespace, topology.name, status)
        except Exception as e:
            if self._is_not_found(e):
                return False
            raise
        # record as soon as the status landed: a later finalizer-patch
        # failure must not break suppression of this patch's echo
        self._pushed_status[topology.key] = status
        self._pushed_spec[topology.key] = (list(topology.spec.links),
                                           manifest.get("spec"))
        self.stats["status_pushed"] += 1
        if hasattr(self.api, "patch_finalizers"):
            try:
                self.api.patch_finalizers(topology.namespace, topology.name,
                                          list(topology.finalizers))
            except Exception as e:
                if not self._is_not_found(e):
                    raise
        return True

    # -- background informer ------------------------------------------

    # transient-failure backoff bounds (client-go reflector shape)
    BACKOFF_INITIAL_S = 1.0
    BACKOFF_MAX_S = 30.0

    @staticmethod
    def _is_expired(e: Exception) -> bool:
        return isinstance(e, WatchExpiredError) or \
            getattr(e, "status", None) == 410

    def run(self, on_error: Callable[[Exception], None] | None = None,
            stop: threading.Event | None = None) -> None:
        """Blocking informer loop: LIST once, then WATCH forever.

        Failure handling distinguishes the two reflector cases instead
        of treating every exception as "sleep 1s, full re-list":

        - **410 Gone / WatchExpiredError** (our resourceVersion fell out
          of the apiserver's retained window): a fresh LIST is the
          correct and ONLY recovery — taken immediately, no backoff
          (waiting cannot un-expire the version).
        - **transient errors** (network blips, apiserver restarts,
          5xx): resume the WATCH from the last seen resourceVersion
          after an exponential backoff (1s → 30s), WITHOUT re-listing —
          at 100k CRs a full LIST per blip is the difference between a
          hiccup and an outage.

        A successful watch event resets the backoff.
        """
        stop = stop if stop is not None else self._stop
        backoff = self.BACKOFF_INITIAL_S
        need_list = True
        while not stop.is_set():
            try:
                if need_list:
                    self.sync_once()
                    need_list = False
                    backoff = self.BACKOFF_INITIAL_S
                for ev in self.api.watch_topologies(self.cluster_rv):
                    if stop.is_set():
                        return
                    self.pump([ev])
                    backoff = self.BACKOFF_INITIAL_S
                # orderly end of stream (server-side watch timeout):
                # immediately re-watch from the last seen version
            except Exception as e:
                if on_error is not None:
                    on_error(e)
                if self._is_expired(e):
                    need_list = True  # re-list NOW; no sleep
                    continue
                stop.wait(backoff)
                backoff = min(backoff * 2.0, self.BACKOFF_MAX_S)

    def start(self) -> None:
        if self._thread is not None:
            return
        # each informer thread owns its own stop event: a predecessor
        # blocked in a never-yielding watch stays permanently stopped and
        # can never revive as a second pump against the same store
        self._stop = threading.Event()
        stop = self._stop
        self._thread = threading.Thread(target=lambda: self.run(stop=stop),
                                        daemon=True, name="k8s-bridge")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
