"""ControllerManager — the controller-runtime manager equivalent.

The reference wraps its reconciler in a controller-runtime Manager with
leader election, health/ready probes, and a signal-driven run loop
(reference main.go:80-126: NewManager with LeaderElection +
LeaderElectionID "ac2ba29f.y-young.github.io", HealthProbeBindAddress,
AddHealthzCheck/AddReadyzCheck, mgr.Start). This module provides the same
operational surface for the in-process stack:

- **Leader election** over a coordination.k8s.io/Lease-shaped record with
  the store's optimistic concurrency as the CAS: candidates try to
  acquire/renew `{holder, acquired_at, renew_at, lease_duration}`; a
  stale lease (renew older than the lease duration) is taken over. Only
  the leader runs reconcile drains — exactly what LeaderElection=true
  buys the reference in an HA deployment.
- **healthz/readyz** on a tiny HTTP server: healthz answers 200 whenever
  the manager thread is alive (healthz.Ping parity); readyz answers 200
  only once the manager completed its initial full resync AND — with
  leader election on — reflects this instance's ability to serve.
- **Run loop**: a background thread pumping watch events through the
  (optionally concurrent) Reconciler until stopped.

Port of kubedtn_tpu/topology/manager.py over the port's Reconciler and
SimEngine, with one repair: the run loop ends the renew thread before it
releases the lease (see _run). The engine's device work stays on one
stream: the reconciler only queues row ops, and the engine's coalesced
flush issues them under its lock on the calling thread's current
stream, the default one for every thread here (the manager's, the renew
thread, the bridge's watch and the gRPC server's workers alike).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubedtn_tpu_torch.topology.reconciler import Reconciler
from kubedtn_tpu_torch.utils.logging import fields as _fields
from kubedtn_tpu_torch.utils.logging import get_logger

# parity with the reference's LeaderElectionID (main.go:87)
LEADER_ELECTION_ID = "ac2ba29f.y-young.github.io"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease essentials."""

    name: str
    holder: str = ""
    acquired_at: float = 0.0
    renewed_at: float = 0.0
    lease_duration_s: float = 15.0
    transitions: int = 0


class LeaseStore:
    """Minimal lease registry with compare-and-swap semantics — the role
    the apiserver's resourceVersion CAS plays for client-go's
    leaderelection package. Thread-safe; shared by all candidates of one
    in-process 'cluster' (in a real cluster this is the Lease CR)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._leases: dict[str, Lease] = {}

    def try_acquire(self, name: str, identity: str, now: float,
                    lease_duration_s: float) -> bool:
        """Acquire if unheld/expired/ours; renew if ours. Atomic."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                self._leases[name] = Lease(
                    name=name, holder=identity, acquired_at=now,
                    renewed_at=now, lease_duration_s=lease_duration_s)
                return True
            if lease.holder == identity:
                lease.renewed_at = now
                return True
            if now - lease.renewed_at > lease.lease_duration_s:
                # stale: take over (leader transition)
                lease.holder = identity
                lease.acquired_at = now
                lease.renewed_at = now
                lease.lease_duration_s = lease_duration_s
                lease.transitions += 1
                return True
            return False

    def release(self, name: str, identity: str) -> None:
        """Voluntary step-down (LeaderElectionReleaseOnCancel semantics —
        the next candidate need not wait out the lease)."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is not None and lease.holder == identity:
                lease.holder = ""
                lease.renewed_at = 0.0

    def holder(self, name: str) -> str:
        with self._lock:
            lease = self._leases.get(name)
            return lease.holder if lease else ""


class KubeLeaseStore:
    """LeaseStore over real coordination.k8s.io/v1 Lease objects — the
    backend that makes leader election work ACROSS manager pods (the
    in-process LeaseStore only arbitrates within one process). Uses the
    apiserver's resourceVersion CAS exactly like client-go's
    leaderelection resourcelock.

    Time domain: the caller's `now` (the manager passes time.monotonic())
    is IGNORED — per-process monotonic clocks are meaningless between
    pods. Freshness is judged on the wall clock (`clock`, default
    time.time; the same NTP assumption client-go's lease durations make),
    and renewTime round-trips as an RFC3339 MicroTime so leases written
    by client-go interoperate.

    Duck-typed to the LeaseStore try_acquire/release/holder surface;
    construction requires the `kubernetes` package (gated, like
    topology.k8s.make_kube_api) or an injected api object with
    read/create/replace_namespaced_lease methods."""

    def __init__(self, namespace: str = "kubedtn-tpu", api=None,
                 clock=None) -> None:
        if api is None:
            try:
                import kubernetes  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "KubeLeaseStore needs the 'kubernetes' package (or an "
                    "injected api); in-process managers can share a plain "
                    "LeaseStore instead") from e
            api = kubernetes.client.CoordinationV1Api()
        self.api = api
        self.namespace = namespace
        self.clock = clock if clock is not None else time.time

    # -- field normalization ------------------------------------------

    @staticmethod
    def _field(obj, camel: str, snake: str, default=None):
        """One accessor for dict manifests (camelCase) and kubernetes
        client models (snake_case attributes)."""
        if obj is None:
            return default
        if isinstance(obj, dict):
            v = obj.get(camel, default)
        else:
            v = getattr(obj, snake, default)
        return default if v is None else v

    @staticmethod
    def _epoch(renew) -> float:
        """renewTime → epoch seconds: accepts datetime (real client),
        RFC3339 string (dict manifests), or a number (test fakes)."""
        import datetime as dt

        if renew is None or renew == "":
            return 0.0
        if isinstance(renew, (int, float)):
            return float(renew)
        if isinstance(renew, str):
            renew = dt.datetime.fromisoformat(renew.replace("Z", "+00:00"))
        if renew.tzinfo is None:
            renew = renew.replace(tzinfo=dt.timezone.utc)
        return renew.timestamp()

    @staticmethod
    def _rfc3339(epoch: float) -> str:
        import datetime as dt

        return dt.datetime.fromtimestamp(
            epoch, dt.timezone.utc).isoformat().replace("+00:00", "Z")

    @staticmethod
    def _is_conflict_or_missing(e: Exception) -> tuple[bool, bool]:
        status = getattr(e, "status", None)
        return status == 409, status == 404

    def _read(self, name: str):
        lease = self.api.read_namespaced_lease(name, self.namespace)
        spec = self._field(lease, "spec", "spec", {})
        meta = self._field(lease, "metadata", "metadata", {})
        return {
            "holder": self._field(spec, "holderIdentity",
                                  "holder_identity", "") or "",
            "renew_epoch": self._epoch(self._field(spec, "renewTime",
                                                   "renew_time", 0.0)),
            "duration": float(self._field(spec, "leaseDurationSeconds",
                                          "lease_duration_seconds", 0)
                              or 0),
            "transitions": int(self._field(spec, "leaseTransitions",
                                           "lease_transitions", 0) or 0),
            "rv": self._field(meta, "resourceVersion", "resource_version"),
        }

    def _body(self, name: str, identity: str, lease_duration_s: float,
              transitions: int, rv=None) -> dict:
        body = {
            "metadata": {"name": name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": identity,
                # apiserver validation requires a positive duration
                "leaseDurationSeconds": max(1, int(lease_duration_s)),
                "renewTime": self._rfc3339(self.clock()),
                "leaseTransitions": transitions,
            },
        }
        if rv is not None:
            body["metadata"]["resourceVersion"] = rv
        return body

    def try_acquire(self, name: str, identity: str, now: float,
                    lease_duration_s: float) -> bool:
        del now  # cross-pod freshness uses self.clock, not caller time
        try:
            cur = self._read(name)
        except Exception as e:
            _, missing = self._is_conflict_or_missing(e)
            if not missing:
                raise
            try:
                self.api.create_namespaced_lease(
                    self.namespace,
                    self._body(name, identity, lease_duration_s, 0))
                return True
            except Exception as e2:
                conflict, _ = self._is_conflict_or_missing(e2)
                if conflict:
                    return False  # racer created it first
                raise
        fresh = cur["holder"] and (
            self.clock() - cur["renew_epoch"] <= (cur["duration"]
                                                  or lease_duration_s))
        if cur["holder"] != identity and fresh:
            return False
        transitions = cur["transitions"] + (
            1 if cur["holder"] and cur["holder"] != identity else 0)
        try:
            self.api.replace_namespaced_lease(
                name, self.namespace,
                self._body(name, identity, lease_duration_s, transitions,
                           rv=cur["rv"]))
            return True
        except Exception as e:
            conflict, _ = self._is_conflict_or_missing(e)
            if conflict:
                return False  # lost the CAS to another candidate
            raise

    def release(self, name: str, identity: str) -> None:
        try:
            cur = self._read(name)
        except Exception:
            return
        if cur["holder"] != identity:
            return
        # empty holder + ancient renewTime: validation-legal and instantly
        # stale, so the next candidate takes over without waiting
        body = self._body(name, "", 1, cur["transitions"], rv=cur["rv"])
        body["spec"]["renewTime"] = self._rfc3339(0.0)
        try:
            self.api.replace_namespaced_lease(name, self.namespace, body)
        except Exception:
            pass  # a failed release just expires naturally

    def holder(self, name: str) -> str:
        try:
            return self._read(name)["holder"]
        except Exception:
            return ""


@dataclass
class ManagerStatus:
    alive: bool = False
    synced: bool = False     # initial full resync completed
    is_leader: bool = False
    reconciles: int = 0
    errors: int = 0
    checks: dict = field(default_factory=dict)


class ManagerCollector:
    """Prometheus collector for the controller side — the role of
    controller-runtime's metrics endpoint (reference main.go:82
    MetricsBindAddress): reconcile totals/errors, leadership gauge,
    sync state. Register with a prometheus_client CollectorRegistry
    (metrics.make_registry-style) and serve via metrics.MetricsServer."""

    def __init__(self, manager: "ControllerManager") -> None:
        self._mgr = manager

    def collect(self):
        from prometheus_client.core import (CounterMetricFamily,
                                            GaugeMetricFamily)

        st = self._mgr.status
        labels = ["identity"]
        values = [self._mgr.identity]

        c = CounterMetricFamily(
            "controller_runtime_reconcile_total",
            "Total number of reconciliations", labels=labels)
        c.add_metric(values, float(st.reconciles))
        yield c
        e = CounterMetricFamily(
            "controller_runtime_reconcile_errors_total",
            "Total number of reconciliation errors", labels=labels)
        e.add_metric(values, float(st.errors))
        yield e
        g = GaugeMetricFamily(
            "leader_election_master_status",
            "1 when this instance holds the leader lease",
            labels=labels)
        g.add_metric(values, 1.0 if st.is_leader else 0.0)
        yield g
        s = GaugeMetricFamily(
            "controller_synced", "1 once the initial resync completed",
            labels=labels)
        s.add_metric(values, 1.0 if st.synced else 0.0)
        yield s


class _ProbeHandler(BaseHTTPRequestHandler):
    manager: "ControllerManager" = None  # set per server

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        mgr = self.manager
        if self.path.startswith("/healthz"):
            ok, body = mgr.healthz()
        elif self.path.startswith("/readyz"):
            ok, body = mgr.readyz()
        else:
            self.send_response(404)
            self.end_headers()
            return
        payload = json.dumps(body).encode()
        self.send_response(200 if ok else 503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):  # probes are too chatty for stdout
        pass


class ControllerManager:
    """Runs a Reconciler continuously with optional leader election and
    health/ready probes (reference main.go:80-126)."""

    # how long a stopping run loop waits for a renewal in flight; it
    # covers one lease call (HttpLeaseApi's timeout is 10 s)
    STOP_TIMEOUT_S = 30.0

    def __init__(self, store, engine, identity: str = "manager-0",
                 workers: int = 1,
                 leader_election: bool = False,
                 lease_store: LeaseStore | None = None,
                 lease_duration_s: float = 2.0,
                 renew_interval_s: float = 0.5,
                 probe_port: int | None = None,
                 probe_host: str = "0.0.0.0",
                 metrics_port: int | None = None,
                 poll_interval_s: float = 0.02) -> None:
        self.store = store
        self.engine = engine
        self.identity = identity
        self.workers = workers
        self.leader_election = leader_election
        self.leases = lease_store if lease_store is not None else LeaseStore()
        self.lease_duration_s = lease_duration_s
        self.renew_interval_s = renew_interval_s
        self.poll_interval_s = poll_interval_s
        self.status = ManagerStatus()
        self.log = get_logger("manager")
        self.reconciler: Reconciler | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._http: ThreadingHTTPServer | None = None
        self._probe_host = probe_host
        self._probe_port_req = probe_port
        self.probe_port: int | None = None
        self.metrics = None
        self._metrics_port_req = metrics_port
        self.metrics_port: int | None = None
        if metrics_port is not None:
            self._start_metrics()
        if probe_port is not None:
            # probes answer from construction (503 until started), like a
            # pod whose kubelet probes begin before the process is ready
            self._start_probes()

    def _start_metrics(self) -> None:
        """Controller metrics endpoint (reference MetricsBindAddress
        :8080, main.go:82). Same never-raise port policy as the probes:
        preferred → requested → any free port."""
        if self.metrics is not None or self._metrics_port_req is None:
            return
        from prometheus_client import CollectorRegistry

        from kubedtn_tpu_torch.metrics.metrics import MetricsServer

        registry = CollectorRegistry()
        registry.register(ManagerCollector(self))
        preferred = self.metrics_port if self.metrics_port is not None \
            else self._metrics_port_req
        for port in dict.fromkeys((preferred, self._metrics_port_req, 0)):
            try:
                self.metrics = MetricsServer(registry, port=port)
                break
            except OSError:
                self.log.warning("metrics port %s unavailable; trying next",
                                 port)
        else:  # pragma: no cover — port 0 cannot fail to bind
            return
        self.metrics.start()
        self.metrics_port = self.metrics.port

    def _start_probes(self) -> None:
        if self._http is not None or self._probe_port_req is None:
            return
        handler = type("Handler", (_ProbeHandler,), {"manager": self})
        # all interfaces by default: kubelet httpGet probes dial the
        # pod IP (reference HealthProbeBindAddress ":8081"); a restart
        # prefers the SAME port the first bind chose, but if someone took
        # it while we were stopped, fall back to the requested port (a
        # fresh ephemeral when that was 0) — start() must never raise
        preferred = self.probe_port if self.probe_port is not None \
            else self._probe_port_req
        # preferred port → requested port → any free port: a restart must
        # come back with probes on SOME port, never raise
        for port in dict.fromkeys((preferred, self._probe_port_req, 0)):
            try:
                self._http = ThreadingHTTPServer(
                    (self._probe_host, port), handler)
                break
            except OSError:
                self.log.warning("probe port %s unavailable; trying next",
                                 port)
        else:  # pragma: no cover — port 0 cannot fail to bind
            return
        self.probe_port = self._http.server_port
        threading.Thread(target=self._http.serve_forever, daemon=True,
                         name=f"probes-{self.identity}").start()

    # -- probes --------------------------------------------------------

    def healthz(self) -> tuple[bool, dict]:
        """healthz.Ping parity: alive ⇔ the manager loop is running."""
        ok = self.status.alive
        return ok, {"status": "ok" if ok else "not started",
                    "checks": {"ping": ok}}

    def readyz(self) -> tuple[bool, dict]:
        """Leader: ready once the initial resync completed. Standby: ready
        by virtue of being able to take over (it has no watch open yet, so
        `synced` cannot be its criterion) — mirroring controller-runtime,
        where readyz does not gate on leadership."""
        standby = (self.leader_election and not self.status.is_leader)
        ok = self.status.alive and (self.status.synced or standby)
        return ok, {
            "status": "ok" if ok else "not ready",
            "checks": {"alive": self.status.alive,
                       "synced": self.status.synced,
                       "standby": standby,
                       "leader": self.status.is_leader},
        }

    # -- leadership ----------------------------------------------------

    def _try_leadership(self, stop: threading.Event) -> bool:
        """One acquire-or-renew. A call that returns after `stop` was set
        (a renewal in flight across a stop) leaves the status alone: it
        belongs to a run that has ended, maybe with a new one started."""
        if not self.leader_election:
            return True
        now = time.monotonic()
        got = self.leases.try_acquire(LEADER_ELECTION_ID, self.identity,
                                      now, self.lease_duration_s)
        if stop.is_set():
            return False
        if got and not self.status.is_leader:
            self.log.info("became leader %s", _fields(
                identity=self.identity, lease=LEADER_ELECTION_ID))
        elif not got and self.status.is_leader:
            self.log.warning("lost leadership %s", _fields(
                identity=self.identity))
        self.status.is_leader = got
        return got

    def _renew_loop(self, stop: threading.Event) -> None:
        """Dedicated lease renewer: leadership is kept alive INDEPENDENTLY
        of drain duration — a multi-second drain (reconcile_100k measures
        seconds) must not let the lease expire mid-drain and split-brain
        into a second concurrent leader."""
        while not stop.is_set():
            if self.status.is_leader:
                self._try_leadership(stop)
            stop.wait(self.renew_interval_s)

    # -- run loop ------------------------------------------------------

    def _run(self, stop: threading.Event,
             renewer: threading.Thread | None) -> None:
        self.status.alive = True
        last_acquire = 0.0
        try:
            while not stop.is_set():
                now = time.monotonic()
                # acquisition only — once leading, the dedicated renew
                # thread keeps the lease alive (doubling renewals here
                # would just double apiserver traffic)
                if not self.status.is_leader and \
                        now - last_acquire >= self.renew_interval_s:
                    self._try_leadership(stop)
                    last_acquire = now
                if not self.status.is_leader and self.leader_election:
                    # standby: stay synced-false until first leadership
                    stop.wait(self.renew_interval_s)
                    continue
                if self.reconciler is None:
                    # the watch opens at leadership start: replay delivers
                    # the full current state (informer initial LIST)
                    self.reconciler = Reconciler(self.store, self.engine)
                try:
                    results = self.reconciler.drain(workers=self.workers)
                    self.status.reconciles += len(results)
                    if not self.status.synced:
                        self.status.synced = True
                        self.log.info("initial resync complete %s", _fields(
                            identity=self.identity,
                            reconciles=self.status.reconciles))
                except Exception:
                    self.status.errors += 1
                    self.log.exception("drain failed (continuing)")
                stop.wait(self.poll_interval_s)
        finally:
            self.status.alive = False
            # the renewer ends before the release: a renewal in flight
            # would otherwise land after it, take the lease back for a
            # stopped manager and set is_leader again, and the standby
            # would wait out a whole lease (the JAX manager's race). A
            # renewal still in flight after STOP_TIMEOUT_S keeps the
            # lease: it is left to expire, never released under it.
            stop.set()
            renewed_out = renewer is None
            if renewer is not None:
                renewer.join(timeout=self.STOP_TIMEOUT_S)
                renewed_out = not renewer.is_alive()
            self.status.is_leader = False
            if self.leader_election:
                if renewed_out:
                    self.leases.release(LEADER_ELECTION_ID, self.identity)
                else:
                    self.log.warning("lease renewal still in flight %s",
                                     _fields(identity=self.identity,
                                             lease="left to expire"))

    def start(self) -> None:
        if self._thread is not None:
            if not self._stop.is_set():
                return   # running
            # a stop() that outwaited its bound: this run's release (or
            # its decision to let the lease expire) comes first
            self._thread.join()
            self._thread = None
        self._start_probes()   # recreate after a stop()
        self._start_metrics()
        # a fresh event per run: a thread of an earlier run that outlived
        # its stop sees its own event set, never a cleared one
        self._stop = stop = threading.Event()
        renewer = None
        if self.leader_election:
            # before the run loop, whose exit joins it
            renewer = threading.Thread(
                target=self._renew_loop, args=(stop,), daemon=True,
                name=f"lease-renew-{self.identity}")
            renewer.start()
        self._thread = threading.Thread(target=self._run,
                                        args=(stop, renewer), daemon=True,
                                        name=f"manager-{self.identity}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # the run loop ends its drain, waits up to STOP_TIMEOUT_S for
            # the renewer, then releases (one lease call, bounded by the
            # lease API's own timeout): wait that long
            self._thread.join(timeout=2 * self.STOP_TIMEOUT_S)
            if self._thread.is_alive():
                self.log.warning("run loop still stopping %s", _fields(
                    identity=self.identity))
            else:
                self._thread = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()  # release the listening socket
            self._http = None
        if self.metrics is not None:
            self.metrics.stop()
            self.metrics = None
