"""A protocol-level fake Kubernetes apiserver for bridge tests.

The port's own copy of tests/fake_apiserver.py (GROUP / VERSION from
kubedtn_tpu_torch; no jax, no JAX package), so chip_smoke.py can load it
by path where only the port is installed. One change, not in the
protocol: each object is JSON-encoded once per write, and its watch
event and its HTTP response send those bytes, so a 100k-link Clos's
status pushes do not re-encode every object several times.

The reference boots etcd + a real apiserver in its controller tests
(reference controllers/suite_test.go:44-80, envtest). This is the same
role at the HTTP layer this repo actually exercises: a ThreadingHTTPServer
speaking the CustomObjects REST surface for Topology CRs —

- LIST  GET  /apis/{g}/{v}/{plural}                       (cluster scope)
        GET  /apis/{g}/{v}/namespaces/{ns}/{plural}
- WATCH same paths with ?watch=true&resourceVersion=N — a streaming
        response of JSON-lines watch events. A resourceVersion older than
        the retained event window answers with the apiserver's actual
        protocol for expiry: HTTP 200 + an ERROR event carrying a
        `Status` object with code 410 ("Expired"), which clients must
        turn into a fresh LIST.
- PATCH .../{name}/status   (application/merge-patch+json)
- PATCH .../{name}          (metadata merge — finalizers)
- POST/PUT/DELETE on objects so tests can drive spec changes like a
  controller-manager would.

Plus the coordination.k8s.io/v1 Lease surface (GET/POST/PUT with
resourceVersion CAS → 409 on mismatch) so KubeLeaseStore runs against it
over real HTTP.

Deliberately faithful bits: a single global, monotonically increasing
resourceVersion; watch events replayed from an in-memory log with a
bounded window (so 410 is reachable); optimistic-concurrency on Lease
replace; JSON-lines chunk framing.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kubedtn_tpu_torch import GROUP, VERSION

PLURAL = "topologies"


class FakeApiServer:
    """In-memory cluster state + the HTTP server around it."""

    def __init__(self, event_window: int = 64,
                 watch_timeout_s: float = 30.0) -> None:
        self._lock = threading.Condition()
        self._rv = 0
        self.objects: dict[tuple[str, str], dict] = {}  # (ns, name) -> obj
        self.leases: dict[tuple[str, str], dict] = {}
        # retained watch log: (rv, type, namespace, the object's JSON)
        self._events: list[tuple[int, str, str, str]] = []
        self.event_window = event_window
        self.watch_timeout_s = watch_timeout_s
        self.requests: list[str] = []  # "<METHOD> <path>" log for tests
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # fault injection: when >0, the next N non-watch requests answer
        # HTTP 500 (transient-error path testing)
        self.fail_next = 0
        # bumped by expire_history: active watch streams terminate so
        # clients must reconnect (and discover their RV is now stale),
        # like an apiserver closing watches on etcd compaction
        self._generation = 0

    # -- state helpers (lock held) ------------------------------------

    def _bump(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _record(self, ev_type: str, obj: dict) -> str:
        """Log a watch event of `obj` as it stands; returns its JSON."""
        raw = json.dumps(obj)
        ns = obj.get("metadata", {}).get("namespace", "default")
        self._events.append((self._rv, ev_type, ns, raw))
        if len(self._events) > self.event_window:
            del self._events[: len(self._events) - self.event_window]
        self._lock.notify_all()
        return raw

    # -- conveniences for the tests -----------------------------------

    def put_object(self, manifest: dict) -> dict:
        """Create or replace a Topology object (spec changes from 'the
        controller-manager'); status is preserved on replace."""
        meta = manifest.setdefault("metadata", {})
        ns = meta.setdefault("namespace", "default")
        name = meta["name"]
        with self._lock:
            old = self.objects.get((ns, name))
            if old is not None and "status" not in manifest:
                manifest = dict(manifest)
                if "status" in old:
                    manifest["status"] = old["status"]
            meta["resourceVersion"] = self._bump()
            self.objects[(ns, name)] = manifest
            self._record("ADDED" if old is None else "MODIFIED", manifest)
        return manifest

    def delete_object(self, ns: str, name: str) -> None:
        with self._lock:
            obj = self.objects.pop((ns, name), None)
            if obj is not None:
                obj["metadata"]["resourceVersion"] = self._bump()
                self._record("DELETED", obj)

    def expire_history(self) -> None:
        """Drop the whole retained watch log (simulates compaction): any
        watch resuming from an old RV now gets 410 Gone."""
        with self._lock:
            self._events.clear()
            # burn some versions so stale RVs are unambiguously old
            self._rv += 100
            self._generation += 1
            self._lock.notify_all()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> tuple[str, int]:
        state = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            # ---- helpers ----
            def _json(self, code: int, obj) -> None:
                """Answer `obj`, or its JSON text when a str."""
                body = (obj if isinstance(obj, str)
                        else json.dumps(obj)).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _status(self, code: int, reason: str, message: str) -> None:
                self._json(code, {
                    "kind": "Status", "apiVersion": "v1", "metadata": {},
                    "status": "Failure", "message": message,
                    "reason": reason, "code": code,
                })

            def _read_body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n)) if n else {}

            def _fail_injected(self) -> bool:
                with state._lock:
                    if state.fail_next > 0:
                        state.fail_next -= 1
                        fail = True
                    else:
                        fail = False
                if fail:
                    self._status(500, "InternalError", "injected fault")
                return fail

            # ---- topology routes ----
            def _topo_path(self, path: str):
                """(ns | None, name | None, subresource | None) for a
                CustomObjects path, else None."""
                base = f"/apis/{GROUP}/{VERSION}"
                if not path.startswith(base + "/"):
                    return None
                rest = path[len(base) + 1:].strip("/").split("/")
                if rest[0] == "namespaces":
                    if len(rest) < 3 or rest[2] != PLURAL:
                        return None
                    ns = rest[1]
                    name = rest[3] if len(rest) > 3 else None
                    sub = rest[4] if len(rest) > 4 else None
                    return ns, name, sub
                if rest[0] != PLURAL:
                    return None
                name = rest[1] if len(rest) > 1 else None
                sub = rest[2] if len(rest) > 2 else None
                return None, name, sub

            def _lease_path(self, path: str):
                base = "/apis/coordination.k8s.io/v1/namespaces/"
                if not path.startswith(base):
                    return None
                rest = path[len(base):].strip("/").split("/")
                if len(rest) < 2 or rest[1] != "leases":
                    return None
                return rest[0], rest[2] if len(rest) > 2 else None

            def _serve_list(self, ns):
                with state._lock:   # one consistent snapshot, encoded
                    items = [o for (ons, _n), o in
                             sorted(state.objects.items())
                             if ns is None or ons == ns]
                    body = json.dumps({
                        "apiVersion": f"{GROUP}/{VERSION}",
                        "kind": "TopologyList",
                        "metadata": {"resourceVersion": str(state._rv)},
                        "items": items,
                    })
                self._json(200, body)

            def _serve_watch(self, ns, rv_from: int):
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def send_event(ev) -> None:
                    line = (ev if isinstance(ev, str)
                            else json.dumps(ev)).encode() + b"\n"
                    self.wfile.write(hex(len(line))[2:].encode() + b"\r\n"
                                     + line + b"\r\n")
                    self.wfile.flush()

                with state._lock:
                    oldest = state._events[0][0] if state._events \
                        else state._rv + 1
                # resuming before the retained window: the apiserver's
                # 410 protocol is an ERROR event, not an HTTP error
                if rv_from + 1 < oldest and rv_from < state._rv:
                    send_event({
                        "type": "ERROR",
                        "object": {
                            "kind": "Status", "apiVersion": "v1",
                            "metadata": {}, "status": "Failure",
                            "reason": "Expired", "code": 410,
                            "message": f"too old resource version: "
                                       f"{rv_from}",
                        },
                    })
                    self.wfile.write(b"0\r\n\r\n")
                    return
                cursor = rv_from
                import time as _t
                with state._lock:
                    gen0 = state._generation
                deadline = _t.monotonic() + state.watch_timeout_s
                try:
                    while _t.monotonic() < deadline:
                        with state._lock:
                            if state._generation != gen0:
                                break  # compaction: close the stream
                            pending = [
                                (rv, t, raw) for (rv, t, ons, raw)
                                in state._events
                                if rv > cursor and (ns is None or ons == ns)]
                            if not pending:
                                state._lock.wait(0.1)
                        for rv, t, raw in pending:
                            send_event(f'{{"type": "{t}", '
                                       f'"object": {raw}}}')
                            cursor = rv
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            # ---- verbs ----
            def do_GET(self):
                u = urlparse(self.path)
                state.requests.append(f"GET {u.path}")
                lease = self._lease_path(u.path)
                if lease is not None:
                    ns, name = lease
                    with state._lock:
                        obj = state.leases.get((ns, name))
                    if obj is None:
                        return self._status(404, "NotFound",
                                            f"lease {name} not found")
                    return self._json(200, obj)
                topo = self._topo_path(u.path)
                if topo is None:
                    return self._status(404, "NotFound", "no such route")
                ns, name, _sub = topo
                if name is None:
                    q = parse_qs(u.query)
                    if q.get("watch", ["false"])[0] in ("true", "1"):
                        rv = int(q.get("resourceVersion", ["0"])[0] or 0)
                        return self._serve_watch(ns, rv)
                    if self._fail_injected():
                        return
                    return self._serve_list(ns)
                with state._lock:
                    obj = state.objects.get((ns or "default", name))
                if obj is None:
                    return self._status(404, "NotFound",
                                        f"{name} not found")
                return self._json(200, obj)

            def do_POST(self):
                u = urlparse(self.path)
                state.requests.append(f"POST {u.path}")
                body = self._read_body()
                lease = self._lease_path(u.path)
                if lease is not None:
                    ns, _ = lease
                    name = body.get("metadata", {}).get("name")
                    with state._lock:
                        if (ns, name) in state.leases:
                            return self._status(409, "AlreadyExists",
                                                f"lease {name} exists")
                        body.setdefault("metadata", {})
                        body["metadata"]["namespace"] = ns
                        body["metadata"]["resourceVersion"] = state._bump()
                        state.leases[(ns, name)] = body
                    return self._json(201, body)
                topo = self._topo_path(u.path)
                if topo is None:
                    return self._status(404, "NotFound", "no such route")
                ns = topo[0] or body.get("metadata", {}) \
                    .get("namespace", "default")
                name = body.get("metadata", {}).get("name")
                with state._lock:
                    if (ns, name) in state.objects:
                        return self._status(409, "AlreadyExists",
                                            f"{name} exists")
                body.setdefault("metadata", {})["namespace"] = ns
                state.put_object(body)
                return self._json(201, body)

            def do_PUT(self):
                u = urlparse(self.path)
                state.requests.append(f"PUT {u.path}")
                body = self._read_body()
                lease = self._lease_path(u.path)
                if lease is not None:
                    ns, name = lease
                    with state._lock:
                        cur = state.leases.get((ns, name))
                        if cur is None:
                            return self._status(404, "NotFound",
                                                f"lease {name} not found")
                        want = body.get("metadata", {}) \
                            .get("resourceVersion")
                        have = cur["metadata"]["resourceVersion"]
                        if want is not None and want != have:
                            return self._status(
                                409, "Conflict",
                                f"resourceVersion mismatch: {want}!={have}")
                        body.setdefault("metadata", {})
                        body["metadata"]["namespace"] = ns
                        body["metadata"]["resourceVersion"] = state._bump()
                        state.leases[(ns, name)] = body
                    return self._json(200, body)
                topo = self._topo_path(u.path)
                if topo is None or topo[1] is None:
                    return self._status(404, "NotFound", "no such route")
                body.setdefault("metadata", {})["namespace"] = \
                    topo[0] or "default"
                state.put_object(body)
                return self._json(200, body)

            def do_PATCH(self):
                u = urlparse(self.path)
                state.requests.append(f"PATCH {u.path}")
                if self._fail_injected():
                    return
                topo = self._topo_path(u.path)
                if topo is None or topo[1] is None:
                    return self._status(404, "NotFound", "no such route")
                ns, name, sub = topo
                ns = ns or "default"
                patch = self._read_body()
                with state._lock:
                    obj = state.objects.get((ns, name))
                    if obj is None:
                        return self._status(404, "NotFound",
                                            f"{name} not found")
                    if sub == "status":
                        obj["status"] = patch.get("status", {})
                    else:
                        meta_patch = patch.get("metadata", {})
                        if "finalizers" in meta_patch:
                            obj["metadata"]["finalizers"] = \
                                meta_patch["finalizers"]
                    obj["metadata"]["resourceVersion"] = state._bump()
                    raw = state._record("MODIFIED", obj)
                return self._json(200, raw)

            def do_DELETE(self):
                u = urlparse(self.path)
                state.requests.append(f"DELETE {u.path}")
                topo = self._topo_path(u.path)
                if topo is None or topo[1] is None:
                    return self._status(404, "NotFound", "no such route")
                ns, name, _ = topo
                state.delete_object(ns or "default", name)
                return self._json(200, {"kind": "Status",
                                        "status": "Success"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="fake-apiserver")
        self._thread.start()
        host, port = self._httpd.server_address
        return host, port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
