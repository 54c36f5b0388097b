"""In-process Topology store with Kubernetes API-server semantics.

The reference's durable state lives entirely in the Topology CR — spec is
desired links, status carries placement (SrcIP/NetNs) and last-applied links
— read and written concurrently by the controller and the CNI daemon with
optimistic concurrency (RetryOnConflict, reference
controllers/topology_controller.go:124-138 and daemon/kubedtn/handler.go:101,125),
plus a finalizer protecting pod teardown (handler.go:125-140).

This store reproduces those semantics in-process so the reconcile/status race
discipline survives intact: per-object resourceVersion, conflict on stale
writes, status-vs-metadata update split, finalizer-gated deletion, and a
watch stream equivalent to the daemon's shared informer
(reference daemon/kubedtn/kubedtn.go:128-142). A K8s-backed implementation
can replace it behind the same interface.
"""

from __future__ import annotations

# (generic deepcopy replaced by Topology.clone — Link immutability makes
# structural sharing safe and ~20x cheaper at 100k-link scale)
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterator

from kubedtn_tpu_torch.api.types import Topology


class ConflictError(Exception):
    """Optimistic-concurrency failure (HTTP 409 equivalent)."""


class NotFoundError(KeyError):
    """Object does not exist (HTTP 404 equivalent)."""


class AlreadyExistsError(Exception):
    """Create of an existing object (HTTP 409 AlreadyExists equivalent)."""


@dataclass(frozen=True)
class WatchEvent:
    type: str  # "ADDED" | "MODIFIED" | "DELETED"
    topology: Topology


def _key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}"


class TopologyStore:
    """Thread-safe optimistic-concurrency store for Topology objects."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._objects: dict[str, Topology] = {}
        self._rv = 0
        self._watchers: list[deque[WatchEvent]] = []
        # Bumped only when some object's placement (status.src_ip/net_ns)
        # may have changed — object create/delete or a status write that
        # touches those fields. Lets the engine cache alive/src-ip answers
        # for an entire reconcile drain (status copy-backs don't move
        # placement, so the cache survives them).
        self._placement_gen = 0

    @property
    def placement_generation(self) -> int:
        with self._lock:
            return self._placement_gen

    # -- internal ------------------------------------------------------

    def _emit(self, event: WatchEvent) -> None:
        for q in self._watchers:
            q.append(event)

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    # -- CRUD ----------------------------------------------------------

    def create(self, topology: Topology) -> Topology:
        with self._lock:
            k = topology.key
            if k in self._objects:
                raise AlreadyExistsError(k)
            obj = topology.clone()
            obj.resource_version = self._next_rv()
            obj.deletion_requested = False
            self._objects[k] = obj
            self._placement_gen += 1
            self._emit(WatchEvent("ADDED", obj.clone()))
            return obj.clone()

    def get(self, namespace: str, name: str) -> Topology:
        with self._lock:
            k = _key(namespace or "default", name)
            if k not in self._objects:
                raise NotFoundError(k)
            return self._objects[k].clone()

    def peek_placement(self, namespace: str, name: str) -> tuple[str, str]:
        """Read (src_ip, net_ns) without cloning the object — the alive
        check runs once per (topology, peer) during reconcile and a full
        clone of a 1000-link CR just to read two strings dominated the
        100k-link drain. Raises NotFoundError like get()."""
        with self._lock:
            k = _key(namespace or "default", name)
            obj = self._objects.get(k)
            if obj is None:
                raise NotFoundError(k)
            return obj.status.src_ip, obj.status.net_ns

    def list(self, namespace: str | None = None) -> list[Topology]:
        with self._lock:
            out = [
                o.clone()
                for o in self._objects.values()
                if namespace is None or o.namespace == namespace
            ]
            return sorted(out, key=lambda t: t.key)

    def _check_and_bump(self, incoming: Topology) -> Topology:
        k = incoming.key
        if k not in self._objects:
            raise NotFoundError(k)
        current = self._objects[k]
        if incoming.resource_version != current.resource_version:
            raise ConflictError(
                f"{k}: stale resourceVersion "
                f"{incoming.resource_version} != {current.resource_version}"
            )
        return current

    def update(self, topology: Topology) -> Topology:
        """Update spec + metadata (finalizers). Like the reference's
        clientset Update (api/clientset/v1beta1/topology.go:141-155)."""
        with self._lock:
            current = self._check_and_bump(topology)
            obj = current.clone()
            obj.spec = topology.spec.clone()
            obj.finalizers = list(topology.finalizers)
            obj.resource_version = self._next_rv()
            self._objects[obj.key] = obj
            self._finalize_if_due(obj.key)
            if obj.key in self._objects:
                self._emit(WatchEvent("MODIFIED", obj.clone()))
            return obj.clone()

    def update_status(self, topology: Topology) -> Topology:
        """Update only the status subresource, like the reference's
        UpdateStatus PUT (api/clientset/v1beta1/topology.go:171-184)."""
        with self._lock:
            current = self._check_and_bump(topology)
            if (current.status.src_ip != topology.status.src_ip
                    or current.status.net_ns != topology.status.net_ns):
                self._placement_gen += 1
            obj = current.clone()
            obj.status = topology.status.clone()
            obj.resource_version = self._next_rv()
            self._objects[obj.key] = obj
            self._emit(WatchEvent("MODIFIED", obj.clone()))
            return obj.clone()

    def delete(self, namespace: str, name: str) -> None:
        """Request deletion; the object lingers while finalizers remain,
        matching the CR finalizer flow the reference relies on to keep
        topology data alive until DestroyPod clears it
        (reference daemon/kubedtn/handler.go:125-140, 559-577)."""
        with self._lock:
            k = _key(namespace or "default", name)
            if k not in self._objects:
                raise NotFoundError(k)
            obj = self._objects[k]
            obj.deletion_requested = True
            obj.resource_version = self._next_rv()
            self._finalize_if_due(k)
            if k in self._objects:
                self._emit(WatchEvent("MODIFIED", obj.clone()))

    def _finalize_if_due(self, k: str) -> None:
        obj = self._objects.get(k)
        if obj is not None and obj.deletion_requested and not obj.finalizers:
            del self._objects[k]
            self._placement_gen += 1
            self._emit(WatchEvent("DELETED", obj.clone()))

    # -- watch ---------------------------------------------------------

    def watch(self, replay: bool = True) -> "Watch":
        """Open a watch stream. With replay=True (default) existing objects
        are delivered first as ADDED events — informer list+watch semantics
        (reference daemon/kubedtn/kubedtn.go:128-142)."""
        with self._lock:
            q: deque[WatchEvent] = deque()
            if replay:
                for obj in self._objects.values():
                    q.append(WatchEvent("ADDED", obj.clone()))
            self._watchers.append(q)
            return Watch(self, q)

    def _unwatch(self, q: deque[WatchEvent]) -> None:
        with self._lock:
            if q in self._watchers:
                self._watchers.remove(q)


class Watch:
    """Pull-based watch stream (informer-equivalent)."""

    def __init__(self, store: TopologyStore, q: deque[WatchEvent]) -> None:
        self._store = store
        self._q = q

    def poll(self) -> Iterator[WatchEvent]:
        while True:
            try:
                yield self._q.popleft()
            except IndexError:
                return

    def close(self) -> None:
        self._store._unwatch(self._q)


def retry_on_conflict(fn: Callable[[], None], retries: int = 5) -> None:
    """client-go RetryOnConflict equivalent: re-read + re-apply on 409.

    Mirrors the retry discipline at reference
    controllers/topology_controller.go:125-138 (DefaultRetry is 5 steps).
    """
    last: ConflictError | None = None
    for _ in range(retries):
        try:
            fn()
            return
        except ConflictError as e:
            last = e
    raise last  # type: ignore[misc]
