"""Deterministic chaos harness for the data plane's fault domains.

Port of kubedtn_tpu/chaos.py (same API, seeding and counters; grpc is
imported only where an injected RPC error is built).

Fault injection at the LINK level is the product itself (loss / corrupt /
reorder / duplicate are link properties); this module injects faults at
the INFRASTRUCTURE level — the failures the fault-domain layer
(runtime._PeerSender breakers, the tick supervisor, checkpoint atomicity)
exists to absorb:

- **peer faults**: blackhole (every RPC to the peer raises UNAVAILABLE),
  added latency, and deterministic flapping (down for `duty_down` of
  every `period_s`, clock-driven so a given schedule replays exactly);
- **dispatch faults**: forced exceptions out of the plane's fused device
  dispatch (the supervisor's degradation ladder trigger);
- **checkpoint faults**: file truncation/corruption emulating a crash
  mid-save (the crash-consistency tests' hammer).

Everything is seeded and clock-injectable: a chaos run with the same
seed, schedule, and clock sequence injects the same faults. Tests and
chip_smoke.py drive it; nothing here is imported by the production
paths (the plane only ever calls an injector the embedder attached).
The migration, probe and plane-kill hooks have no caller in the port
yet (they belong to the federation).
"""

from __future__ import annotations

import os
import random
import threading
import time


class ChaosError(RuntimeError):
    """A fault injected into an in-process hook (dispatch failures)."""


def _injected_rpc_error(code_name: str = "UNAVAILABLE"):
    """A synthetic grpc.RpcError carrying a real status code — what a
    blackholed peer's channel would raise, minus the wait."""
    import grpc

    class _InjectedRpcError(grpc.RpcError):
        def __init__(self, code) -> None:
            super().__init__(f"chaos-injected {code}")
            self._code = code

        def code(self):
            return self._code

        def details(self):
            return "chaos-injected fault"

    return _InjectedRpcError(getattr(grpc.StatusCode, code_name))


class _PeerFault:
    """One peer's fault schedule: permanent blackhole, fixed added
    latency, and/or a deterministic flap wave."""

    __slots__ = ("blackholed", "latency_s", "flap_period_s", "flap_duty",
                 "flap_t0")

    def __init__(self) -> None:
        self.blackholed = False
        self.latency_s = 0.0
        self.flap_period_s = 0.0
        self.flap_duty = 0.0
        self.flap_t0 = 0.0


class _ChaosPeerClient:
    """Proxy around a real peer-daemon client: consults the injector
    before every RPC, then forwards. Injected failures raise a real
    grpc.RpcError subclass so the sender's transient-error handling is
    exercised, not special-cased."""

    def __init__(self, injector: "ChaosInjector", addr: str,
                 real) -> None:
        self._injector = injector
        self._addr = addr
        self._real = real

    def __getattr__(self, name):
        real_method = getattr(self._real, name)
        if not callable(real_method):
            return real_method
        injector, addr = self._injector, self._addr

        def call(*args, **kwargs):
            injector.before_peer_rpc(addr, name)
            return real_method(*args, **kwargs)

        return call


class ChaosInjector:
    """Seeded, deterministic fault injector. Attach to a daemon with
    `install_peer_faults(daemon)` (wraps its peer-client factory) and to
    a plane by assigning `plane.chaos = injector` (the dispatch hook).
    Counters in `injected` record every fault fired, keyed by kind."""

    def __init__(self, seed: int = 0, clock=time.monotonic) -> None:
        self.rng = random.Random(seed)
        self.clock = clock
        self._peers: dict[str, _PeerFault] = {}
        self._lock = threading.Lock()
        # dispatch-failure plan: fail the next N dispatches, and/or every
        # k-th dispatch
        self._fail_next_dispatches = 0
        self._fail_every_k = 0
        self._dispatch_seen = 0
        # migration-step failure plan: step name -> remaining failures
        # (the federation state machine calls on_migration_step at each
        # step's crash window — after its side effects, before the
        # journal commit — so an injected failure is exactly a daemon
        # dying mid-step)
        self._fail_steps: dict[str, int] = {}
        # health-probe failure plan: plane name -> remaining failures
        # (the fleet supervisor's suspicion machine consumes these as
        # hard probe failures)
        self._fail_probes: dict[str, int] = {}
        self.injected = {"peer_blackhole": 0, "peer_latency": 0,
                         "dispatch": 0, "checkpoint": 0, "migration": 0,
                         "probe": 0, "plane_kill": 0}

    # -- peer faults ---------------------------------------------------

    def _fault(self, addr: str) -> _PeerFault:
        with self._lock:
            return self._peers.setdefault(addr, _PeerFault())

    def blackhole_peer(self, addr: str) -> None:
        self._fault(addr).blackholed = True

    def heal_peer(self, addr: str) -> None:
        with self._lock:
            self._peers.pop(addr, None)

    def add_peer_latency(self, addr: str, delay_s: float) -> None:
        self._fault(addr).latency_s = float(delay_s)

    def flap_peer(self, addr: str, period_s: float,
                  duty_down: float = 0.5, t0: float | None = None) -> None:
        """Deterministic square wave: the peer is DOWN for the first
        `duty_down` fraction of every `period_s`, starting at `t0`
        (default: now on the injector's clock)."""
        f = self._fault(addr)
        f.flap_period_s = float(period_s)
        f.flap_duty = min(1.0, max(0.0, duty_down))
        f.flap_t0 = self.clock() if t0 is None else float(t0)

    def peer_down(self, addr: str) -> bool:
        """Is the peer blackholed at this instant (static or flap)?"""
        with self._lock:
            f = self._peers.get(addr)
        if f is None:
            return False
        if f.blackholed:
            return True
        if f.flap_period_s > 0.0:
            phase = ((self.clock() - f.flap_t0) % f.flap_period_s)
            return phase < f.flap_duty * f.flap_period_s
        return False

    def before_peer_rpc(self, addr: str, method: str) -> None:
        """Gate every proxied peer RPC: raise for a down peer, sleep for
        an impaired one."""
        if self.peer_down(addr):
            self.injected["peer_blackhole"] += 1
            raise _injected_rpc_error("UNAVAILABLE")
        with self._lock:
            f = self._peers.get(addr)
            delay = f.latency_s if f is not None else 0.0
        if delay > 0.0:
            self.injected["peer_latency"] += 1
            time.sleep(delay)

    def install_peer_faults(self, daemon) -> None:
        """Wrap the daemon's peer-client factory so every peer RPC runs
        through this injector. Idempotent per daemon."""
        if getattr(daemon, "_chaos_injector", None) is self:
            return
        real = daemon._peer_wire_client

        def wrapped(addr: str):
            return _ChaosPeerClient(self, addr, real(addr))

        daemon._peer_wire_client = wrapped
        daemon._chaos_injector = self

    # -- dispatch faults ----------------------------------------------

    def fail_next_dispatches(self, n: int) -> None:
        self._fail_next_dispatches += int(n)

    def fail_every_kth_dispatch(self, k: int) -> None:
        """k <= 0 disables the periodic plan."""
        self._fail_every_k = int(k)

    def on_dispatch(self) -> None:
        """Hook the plane calls at the head of every shaping dispatch;
        raising here exercises the requeue-on-failure path plus the
        supervisor's degradation ladder (frames must never be lost)."""
        self._dispatch_seen += 1
        fire = False
        if self._fail_next_dispatches > 0:
            self._fail_next_dispatches -= 1
            fire = True
        elif (self._fail_every_k > 0
              and self._dispatch_seen % self._fail_every_k == 0):
            fire = True
        if fire:
            self.injected["dispatch"] += 1
            raise ChaosError(
                f"chaos: forced dispatch failure #{self.injected['dispatch']}")

    # -- migration-step faults ----------------------------------------

    def fail_migration_step(self, step: str, times: int = 1) -> None:
        """Arm a failure at the named migration step (throttle | fork |
        restore | cutover | reconcile | release): the next `times`
        times the state machine reaches that step's crash window —
        side effects applied, journal commit NOT yet written — it
        raises, modeling a daemon crash at the worst instant of that
        step."""
        with self._lock:
            self._fail_steps[step] = self._fail_steps.get(step, 0) \
                + int(times)

    def on_migration_step(self, step: str) -> None:
        """Hook the migration coordinator calls inside every step."""
        with self._lock:
            left = self._fail_steps.get(step, 0)
            if left <= 0:
                return
            self._fail_steps[step] = left - 1
            self.injected["migration"] += 1
        raise ChaosError(f"chaos: forced migration failure at "
                         f"step {step!r}")

    # -- fleet faults --------------------------------------------------

    def fail_probes(self, plane: str, times: int = 1) -> None:
        """Arm `times` hard failures of the fleet supervisor's health
        probe of `plane` — the suspicion state machine's hammer (a
        transiently unreachable daemon that comes back)."""
        with self._lock:
            self._fail_probes[plane] = \
                self._fail_probes.get(plane, 0) + int(times)

    def on_probe(self, plane: str) -> None:
        """Hook the fleet supervisor calls before every health probe."""
        with self._lock:
            left = self._fail_probes.get(plane, 0)
            if left <= 0:
                return
            self._fail_probes[plane] = left - 1
            self.injected["probe"] += 1
        raise ChaosError(f"chaos: forced probe failure of {plane!r}")

    def kill_plane(self, handle, server=None) -> None:
        """`kill -9` stand-in for an IN-PROCESS plane: the runner
        thread is abandoned mid-flight (its stop flag is set with NO
        flush and NO checkpoint — whatever lived in queues, delay
        lines and un-checkpointed counters is gone exactly as a
        SIGKILL leaves it), the gRPC server (when given) stops taking
        connections, and every subsequent in-process health probe
        raises (`daemon.chaos_dead`). The plane object is
        unrecoverable from here on, like the process it stands for."""
        plane = handle.plane
        plane._stop.set()
        wake = getattr(plane, "_wake", None)
        if wake is not None:
            wake.set()  # a sleeping runner sees the stop immediately
        handle.daemon.chaos_dead = True
        if server is not None:
            server.stop(None)
        self.injected["plane_kill"] += 1

    # -- checkpoint faults --------------------------------------------

    def truncate_file(self, path: str, keep_fraction: float = 0.5) -> int:
        """Truncate a checkpoint file to a deterministic fraction of its
        size — the on-disk shape of a crash mid-write. Returns the new
        size."""
        size = os.path.getsize(path)
        keep = int(size * keep_fraction)
        with open(path, "r+b") as f:
            f.truncate(keep)
        self.injected["checkpoint"] += 1
        return keep

    def corrupt_file(self, path: str, n_bytes: int = 1) -> list[int]:
        """Flip `n_bytes` seeded-random bytes in place (checksum-
        mismatch corruption, size unchanged). Returns the offsets."""
        size = os.path.getsize(path)
        offsets = sorted(self.rng.randrange(size)
                         for _ in range(max(1, n_bytes)))
        with open(path, "r+b") as f:
            for off in offsets:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0xFF]))
        self.injected["checkpoint"] += 1
        return offsets
