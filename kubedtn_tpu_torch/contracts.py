"""Concurrency contracts: the `@guarded_by` attribute registry and the
instrumented lock harness that enforces lock-ordering at runtime.

Five review rounds per PR kept finding the same two defect shapes by
hand: a plane/sender/telemetry attribute touched off its owning lock
(torn counters, racy ring reads) and lock-acquisition orders that only
deadlock under load. This module turns both into declared, checkable
contracts:

- ``@guarded_by("_tick_lock", "attr", ...)`` on a class declares which
  lock owns which attributes. The static side
  (``kubedtn_tpu.analysis.passes.lock_discipline``) parses the same
  decorator from the AST and flags any ``self.attr`` access outside a
  ``with self._tick_lock`` block; the declaration also lands in a
  runtime registry (``guarded_attrs``) so tests can introspect it.
- ``@requires_lock("_tick_lock")`` on a method declares "my caller
  holds the lock" — the static pass treats the whole method body as
  covered instead of flagging every line.
- ``InstrumentedLock`` wraps a real ``threading.Lock``/``RLock`` and
  records every held→acquiring pair into a shared ``LockOrderGraph``;
  the graph raises ``LockOrderError`` the moment an acquisition closes
  a cycle (the classic AB/BA inversion), instead of leaving the
  deadlock to a soak run. ``instrument_locks`` swaps an object's lock
  attributes in place for tests.

No jax / numpy imports here: the decorators are applied at import time
by ``runtime.py`` / ``telemetry.py`` / ``fault.py`` and must stay
dependency-free and cheap.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, TypeVar

_C = TypeVar("_C", bound=type)
_F = TypeVar("_F", bound=Callable[..., Any])

# class qualname ("module.Class") -> {attribute name: owning lock name}
_GUARDED: dict[str, dict[str, str]] = {}


def guarded_by(lock: str, *attrs: str) -> Callable[[_C], _C]:
    """Class decorator: the listed attributes are owned by ``self.<lock>``.

    Purely declarative at runtime (a registry entry plus a
    ``__dtnlint_guarded__`` mapping on the class); the static pass and
    the test harness do the enforcement.
    """

    def deco(cls: _C) -> _C:
        key = f"{cls.__module__}.{cls.__qualname__}"
        reg = _GUARDED.setdefault(key, {})
        merged = dict(getattr(cls, "__dtnlint_guarded__", {}))
        for a in attrs:
            reg[a] = lock
            merged[a] = lock
        cls.__dtnlint_guarded__ = merged  # type: ignore[attr-defined]
        return cls

    return deco


def requires_lock(lock: str) -> Callable[[_F], _F]:
    """Method decorator: the caller holds ``self.<lock>`` for the whole
    call. The static lock pass treats the body as covered."""

    def deco(fn: _F) -> _F:
        held = set(getattr(fn, "__dtnlint_requires__", ()))
        held.add(lock)
        fn.__dtnlint_requires__ = frozenset(held)  # type: ignore[attr-defined]
        return fn

    return deco


def guarded_attrs(cls: type) -> dict[str, str]:
    """The attribute→lock map a class (or its bases) declared."""
    return dict(getattr(cls, "__dtnlint_guarded__", {}))


def registry() -> dict[str, dict[str, str]]:
    """Snapshot of every ``guarded_by`` declaration seen this process."""
    return {k: dict(v) for k, v in _GUARDED.items()}


class LockOrderError(AssertionError):
    """An instrumented acquisition closed a cycle in the lock-order
    graph — the AB/BA inversion that deadlocks under contention."""


class LockOrderGraph:
    """Directed held→acquiring edges over named locks, cycle-checked on
    every new edge. Shared by all ``InstrumentedLock``s of one harness;
    thread-safe."""

    def __init__(self, raise_on_cycle: bool = True) -> None:
        self.raise_on_cycle = raise_on_cycle
        self._edges: dict[str, set[str]] = {}
        self._mu = threading.Lock()
        self.violations: list[str] = []

    def record(self, held: str, acquiring: str) -> None:
        if held == acquiring:  # re-entrant RLock acquisition
            return
        with self._mu:
            known = acquiring in self._edges.get(held, ())
            self._edges.setdefault(held, set()).add(acquiring)
            if known:
                return
            cycle = self._find_path(acquiring, held)
            if cycle is not None:
                msg = (f"lock-order cycle: acquiring {acquiring!r} while "
                       f"holding {held!r}, but an established order runs "
                       + " -> ".join([*cycle, acquiring]))
                self.violations.append(msg)
        if cycle is not None and self.raise_on_cycle:
            raise LockOrderError(msg)

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src→dst over recorded edges (caller holds _mu)."""
        stack: list[tuple[str, list[str]]] = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def assert_acyclic(self) -> None:
        if self.violations:
            raise LockOrderError("; ".join(self.violations))


class InstrumentedLock:
    """Drop-in wrapper over a ``threading.Lock``/``RLock`` that feeds a
    ``LockOrderGraph``. Each thread's held-lock stack is tracked in a
    class-level ``threading.local`` shared by every instrumented lock,
    so cross-lock ordering is observed no matter which objects own
    them."""

    _tls = threading.local()

    def __init__(self, name: str, graph: LockOrderGraph,
                 lock: Any | None = None) -> None:
        self.name = name
        self.graph = graph
        self._lock = lock if lock is not None else threading.Lock()

    @classmethod
    def _stack(cls) -> list["InstrumentedLock"]:
        stack = getattr(cls._tls, "stack", None)
        if stack is None:
            stack = []
            cls._tls.stack = stack
        return stack

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        for held in self._stack():
            self.graph.record(held.name, self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._stack().append(self)
        return ok

    def release(self) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._lock.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()


def instrument_locks(obj: Any, graph: LockOrderGraph,
                     attrs: Iterable[str]) -> dict[str, InstrumentedLock]:
    """Swap ``obj``'s named lock attributes for instrumented wrappers
    (tests only). Returns the wrappers by attribute name."""
    out: dict[str, InstrumentedLock] = {}
    for a in attrs:
        real = getattr(obj, a)
        name = f"{type(obj).__name__}.{a}"
        wrapped = InstrumentedLock(name, graph, lock=real)
        setattr(obj, a, wrapped)
        out[a] = wrapped
    return out
