"""The port's fault-domain layer held against the JAX package's: the
per-peer sender (runtime._PeerSender) under the same fake daemon, the
same scripted peer failures and the same fake breaker clock; and the
chaos harness (chaos.py) with its dispatch faults on the live plane.

The peer is a scripted client: each RPC consumes the next outcome of a
list (a grpc status code name, or "ok"), whatever the method, and a
failing call raises before it reads a frame, as an unreachable peer
does. The breakers run on a clock that advances a fixed step each time
it is read, and only the sender's thread reads it, so the transitions
depend on the order of the calls alone; the backoff waits are a few
milliseconds of real time and move no counter. Every wait is bounded.
"""

import random
import threading

import grpc
import numpy as np
import pytest

import kubedtn_tpu.chaos as jchaos
import kubedtn_tpu.fault as jfault
import kubedtn_tpu.runtime as jrt
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu_torch.chaos as tchaos
import kubedtn_tpu_torch.fault as tfault
import kubedtn_tpu_torch.runtime as trt
import kubedtn_tpu_torch.wire.proto as tpb

from test_torch_plane import DT, build, frames_for

PKGS = {"jax": (jrt, jfault, jpb, jchaos), "torch": (trt, tfault, tpb,
                                                      tchaos)}
WAIT_S = 20.0


class _RpcErr(grpc.RpcError):
    def __init__(self, code) -> None:
        self._c = code

    def code(self):
        return self._c


class StepClock:
    """Advances `step` seconds on every read."""

    def __init__(self, step: float = 0.01) -> None:
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


class ScriptedClient:
    """Each call takes the next outcome of `script` ("ok" past its end);
    `gate`, when set, holds the FIRST call until released."""

    def __init__(self, script, gate: threading.Event | None = None):
        self.script = list(script)
        self.calls: list[tuple[str, int, str]] = []
        self.got: list[bytes] = []
        self.gate = gate
        self.started = threading.Event()

    def _outcome(self, method: str, n: int) -> None:
        self.started.set()
        if self.gate is not None and len(self.calls) == 0:
            self.gate.wait(WAIT_S)
        out = self.script.pop(0) if self.script else "ok"
        self.calls.append((method, n, out))
        if out != "ok":
            raise _RpcErr(getattr(grpc.StatusCode, out))

    def SendToBulk(self, it, timeout=None):
        batches = list(it)
        frames = [p.frame for b in batches for p in b.packets]
        self._outcome("SendToBulk", len(frames))
        self.got.extend(frames)

    def SendToStream(self, it, timeout=None):
        frames = [p.frame for p in it]
        self._outcome("SendToStream", len(frames))
        self.got.extend(frames)


class FakeDaemon:
    forward_timeout_s = 0.2

    def __init__(self, client) -> None:
        self.client = client
        self.peer_bulk_ok: dict = {}
        self.forward_errors = 0
        self.recorder = None
        self._l = threading.Lock()

    def _peer_wire_client(self, addr):
        return self.client

    def count_forward_errors(self, n: int) -> None:
        with self._l:
            self.forward_errors += n

    def reset_peer_bulk(self, addr: str) -> None:
        self.peer_bulk_ok.pop(addr, None)


class FakeRecorder:
    def __init__(self) -> None:
        self.events: list = []
        self._l = threading.Lock()

    def record(self, tid, stage, **detail):
        with self._l:
            self.events.append((tid, stage, tuple(sorted(detail.items()))))


def _packets(pb, n, base=0):
    return [pb.Packet(remot_intf_id=7, frame=(base + i).to_bytes(4, "big")
                      * 10) for i in range(n)]


# scenario: (script, [(frames, traced)] per enqueue, sender knobs)
SCENARIOS = {
    # three failures open the breaker; the first probe fails (cooldown
    # doubles), the second succeeds: nothing lost, nothing counted as
    # an error
    "transient-outage": dict(
        script=["UNAVAILABLE"] * 5, batches=[(50, [(0, 11), (49, 22)])]),
    # a fatal code drops the slice into forward_errors without retry
    "fatal-code": dict(script=["INVALID_ARGUMENT"], batches=[(10, [])]),
    # a nominally transient code that never heals gives up after
    # MAX_SLICE_RETRIES (the breaker stays closed at threshold 100)
    "slice-retry-budget": dict(
        script=["RESOURCE_EXHAUSTED"] * 10, batches=[(10, [(3, 33)])],
        threshold=100, max_slice_retries=4),
    # a reference-built peer: UNIMPLEMENTED latches the per-frame
    # stream; an outage later, the half-open probe re-tests the bulk
    # path, which the upgraded peer now speaks
    "bulk-relatch-at-probe": dict(
        script=["UNIMPLEMENTED", "ok", "UNAVAILABLE", "UNAVAILABLE",
                "UNAVAILABLE"],
        batches=[(10, []), (10, [])]),
    # the stream-only latch re-probed while idle (no outage)
    "bulk-relatch-idle": dict(
        script=["UNIMPLEMENTED", "ok", "UNIMPLEMENTED", "ok"],
        batches=[(5, []), (5, []), (5, [])], reprobe_s=0.0),
    # slices of SEND_SLICE frames advance through a large buffer in
    # order, a failed slice retried alone
    "slices-in-order": dict(
        script=["ok", "UNAVAILABLE", "ok", "UNAVAILABLE"],
        batches=[(20_000, [(8_200, 44), (19_999, 55)])]),
}


def run_sender(pkg, script, batches, threshold=3, max_slice_retries=None,
               reprobe_s=None, max_queued=None, gate=False, client=None,
               forward_timeout_s=None):
    rt, fault, pb, _ = PKGS[pkg]
    cls = rt._PeerSender
    saved = (cls.MAX_SLICE_RETRIES, cls.BULK_REPROBE_S, cls.MAX_QUEUED)
    if max_slice_retries is not None:
        cls.MAX_SLICE_RETRIES = max_slice_retries
    cls.BULK_REPROBE_S = 1e9 if reprobe_s is None else reprobe_s
    if max_queued is not None:
        cls.MAX_QUEUED = max_queued
    g = threading.Event() if gate else None
    client = client or ScriptedClient(script, gate=g)
    d = FakeDaemon(client)
    if forward_timeout_s is not None:
        d.forward_timeout_s = forward_timeout_s
    d.recorder = FakeRecorder()
    s = cls(d, "peer:1",
            breaker=fault.CircuitBreaker(failure_threshold=threshold,
                                         reset_timeout_s=0.05,
                                         clock=StepClock()),
            backoff=fault.Backoff(base_s=0.001, max_s=0.002,
                                  rng=random.Random(0)))
    accepted = []
    try:
        base = 0
        for bi, (n, traced) in enumerate(batches):
            accepted.append(s.enqueue(_packets(pb, n, base), traced=traced))
            base += n
            if gate and bi == 0:
                # the first batch is drained into the retry buffer and
                # its first call is in flight: the next enqueue sees it
                assert client.started.wait(WAIT_S)
                continue
            if gate:
                g.set()
            assert s.wait_empty(WAIT_S)
        b = s.breaker
        return {"accepted": accepted, "sent": s.sent, "dropped": s.dropped,
                "retries": s.retries, "forward_errors": d.forward_errors,
                "breaker": (b.opens, b.half_opens, b.closes, b.state),
                "calls": client.calls, "got": client.got,
                "bulk_ok": d.peer_bulk_ok.get("peer:1", True),
                "events": d.recorder.events, "buffered": s.buffered}
    finally:
        if g is not None:
            g.set()
        s.stop(WAIT_S)
        (cls.MAX_SLICE_RETRIES, cls.BULK_REPROBE_S,
         cls.MAX_QUEUED) = saved


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_peer_sender_equals_jax(name):
    sc = SCENARIOS[name]
    j = run_sender("jax", **sc)
    t = run_sender("torch", **sc)
    assert t == j
    n = sum(b[0] for b in sc["batches"])
    assert t["sent"] + t["dropped"] + t["forward_errors"] == n
    assert t["buffered"] == 0
    if name == "transient-outage":
        assert t["sent"] == 50 and t["retries"] == 5
        assert t["breaker"][:3] == (3, 3, 1)
    if name in ("fatal-code", "slice-retry-budget"):
        assert t["forward_errors"] == 10 and t["sent"] == 0
    if name.startswith("bulk-relatch"):
        assert t["bulk_ok"] is True and t["calls"][-1][0] == "SendToBulk"
        assert any(c[0] == "SendToStream" for c in t["calls"])
    if name == "slices-in-order":
        assert [c[1] for c in t["calls"]] == [8192, 8192, 8192, 3616,
                                              3616]
    if t["sent"] == n:
        assert t["got"] == [i.to_bytes(4, "big") * 10 for i in range(n)]


def test_outage_buffer_bound_equals_jax():
    """MAX_QUEUED bounds queued + retry-pending frames: with the first
    batch held in flight, the next enqueue takes only the remaining
    room; the rest is dropped and counted, the same in both packages."""
    kw = dict(script=["UNAVAILABLE"], batches=[(80, []), (80, [(30, 7)])],
              max_queued=100, gate=True)
    j = run_sender("jax", **kw)
    t = run_sender("torch", **kw)
    assert t == j
    assert t["accepted"] == [80, 20] and t["dropped"] == 60
    assert t["sent"] == 100 and len(t["got"]) == 100


class SlowStreamPeer:
    """A reference-built peer (SendToBulk UNIMPLEMENTED) that ingests
    the per-frame stream at `rate` frames per second of virtual time. A
    call keeps every frame it reads before the call's deadline, then
    fails DEADLINE_EXCEEDED, as a live peer still consuming the stream
    does when the client's deadline cuts it."""

    def __init__(self, rate: float) -> None:
        self.per_frame_s = 1.0 / rate
        self.calls: list[tuple[str, int, str]] = []
        self.got: list[bytes] = []

    def SendToBulk(self, it, timeout=None):
        self.calls.append(("SendToBulk", 0, "UNIMPLEMENTED"))
        raise _RpcErr(grpc.StatusCode.UNIMPLEMENTED)

    def SendToStream(self, it, timeout=None):
        n = 0
        for p in it:
            if (n + 1) * self.per_frame_s > timeout:
                self.calls.append(("SendToStream", n, "DEADLINE_EXCEEDED"))
                raise _RpcErr(grpc.StatusCode.DEADLINE_EXCEEDED)
            self.got.append(p.frame)
            n += 1
        self.calls.append(("SendToStream", n, "ok"))


def _default_forward_timeout_s() -> float:
    import inspect

    import kubedtn_tpu.wire.server as jsrv
    import kubedtn_tpu_torch.wire.server as tsrv

    j, t = (inspect.signature(m.Daemon.__init__)
            .parameters["forward_timeout_s"].default for m in (jsrv, tsrv))
    assert j == t
    return t


@pytest.mark.parametrize("floor", ["default", 30.0])
def test_slow_stream_peer_outlives_slice_deadline_like_jax(floor):
    """The slice deadline, forward_timeout_s + PER_CHUNK_TIMEOUT_S per
    256-frame chunk, is priced for bulk chunks. A stream-only peer that
    takes fewer than 256 frames per 0.02 s (here 2,000 frames/s) cannot
    take a full SEND_SLICE before it at the Daemon's default floor: each
    attempt delivers the slice's head again, the slice never advances,
    and after MAX_SLICE_RETRIES it is counted in forward_errors while
    the peer holds duplicates of its head. Both packages do the same; a
    30 s floor delivers the slice once, in order."""
    n = trt._PeerSender.SEND_SLICE
    fts = _default_forward_timeout_s() if floor == "default" else floor
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = run_sender(pkg, [], [(n, [])], threshold=100,
                              client=SlowStreamPeer(rate=2_000.0),
                              forward_timeout_s=fts)
    t = out["torch"]
    assert t == out["jax"]
    assert t["calls"][0] == ("SendToBulk", 0, "UNIMPLEMENTED")
    assert t["bulk_ok"] is False and t["buffered"] == 0
    if floor == "default":
        attempts = trt._PeerSender.MAX_SLICE_RETRIES
        head = t["calls"][1][1]
        assert 0 < head < n
        assert t["calls"][1:] == [("SendToStream", head,
                                   "DEADLINE_EXCEEDED")] * attempts
        assert t["sent"] == 0 and t["forward_errors"] == n
        assert t["retries"] == attempts - 1
        assert t["got"] == _frame_bytes(head) * attempts
    else:
        assert t["calls"][1:] == [("SendToStream", n, "ok")]
        assert t["sent"] == n and t["retries"] == 0
        assert t["forward_errors"] == 0
        assert t["got"] == _frame_bytes(n)


def _frame_bytes(n):
    return [i.to_bytes(4, "big") * 10 for i in range(n)]


def test_stop_with_peer_down_drops_and_counts():
    """A sender stopped while its breaker is open gives its buffer up,
    counted in `dropped` (not forward_errors), in both packages."""
    out = {}
    for pkg in ("jax", "torch"):
        rt, fault, pb, _ = PKGS[pkg]
        client = ScriptedClient(["UNAVAILABLE"] * 1000)
        d = FakeDaemon(client)
        s = rt._PeerSender(
            d, "peer:1",
            breaker=fault.CircuitBreaker(failure_threshold=1,
                                         reset_timeout_s=3600.0,
                                         clock=StepClock()),
            backoff=fault.Backoff(base_s=0.001, max_s=0.002,
                                  rng=random.Random(0)))
        s.enqueue(_packets(pb, 12))
        deadline = threading.Event()
        for _ in range(int(WAIT_S / 0.01)):
            if s.breaker.opens:
                break
            deadline.wait(0.01)
        s.stop(WAIT_S)
        assert not s._thread.is_alive()
        out[pkg] = (s.dropped, s.sent, d.forward_errors, s.breaker.opens,
                    len(client.calls))
    assert out["torch"] == out["jax"] == (12, 0, 0, 1, 1)


# -- the chaos harness ---------------------------------------------------------

def test_injector_counters_and_file_faults_equal_jax(tmp_path):
    data = bytes(np.random.default_rng(3).integers(0, 256, 4096,
                                                   dtype=np.uint8))
    out = {}
    for pkg in ("jax", "torch"):
        chaos = PKGS[pkg][3]
        inj = chaos.ChaosInjector(seed=11, clock=StepClock(0.007))
        p1, p2 = tmp_path / f"{pkg}-t", tmp_path / f"{pkg}-c"
        p1.write_bytes(data)
        p2.write_bytes(data)
        keep = inj.truncate_file(str(p1), keep_fraction=0.37)
        offs = inj.corrupt_file(str(p2), n_bytes=9)
        offs2 = inj.corrupt_file(str(p2), n_bytes=3)
        inj.flap_peer("b:1", period_s=0.05, duty_down=0.5)
        downs = [inj.peer_down("b:1") for _ in range(40)]
        codes = []
        for _ in range(20):
            try:
                inj.before_peer_rpc("b:1", "SendToBulk")
                codes.append("ok")
            except grpc.RpcError as e:
                codes.append(e.code().name)
        inj.blackhole_peer("c:1")
        with pytest.raises(grpc.RpcError):
            inj.before_peer_rpc("c:1", "SendToOnce")
        inj.heal_peer("c:1")
        inj.before_peer_rpc("c:1", "SendToOnce")
        inj.fail_next_dispatches(2)
        inj.fail_every_kth_dispatch(4)
        fired = []
        for _ in range(12):
            try:
                inj.on_dispatch()
                fired.append(False)
            except chaos.ChaosError:
                fired.append(True)
        inj.fail_migration_step("fork", 2)
        inj.fail_probes("p", 1)
        raised = 0
        for hook, arg in (("on_migration_step", "fork"),) * 3 + (
                ("on_probe", "p"),) * 2:
            try:
                getattr(inj, hook)(arg)
            except chaos.ChaosError:
                raised += 1
        out[pkg] = (keep, p1.read_bytes(), offs, offs2, p2.read_bytes(),
                    downs, codes, fired, raised, dict(inj.injected))
    assert out["torch"] == out["jax"]
    assert 0 < sum(out["torch"][5]) < 40
    assert out["torch"][7][:2] == [True, True]


CHAOS_PROPS = (dict(latency="10ms"), dict(latency="3ms"),
               dict(latency="2ms", rate="200Mbit"))
CHAOS_COUNTS = (9, 17, 5)
CHAOS_FEED = 12
CHAOS_DRAIN = 16


def chaos_run(pkg, depth, faults: bool):
    """A deterministic-link plane on an explicit clock, the supervisor
    stepped after every tick attempt as the runner does, a failed tick
    retried at once on the same clock: with `faults`, four dispatches
    fail at tick 2 (the ladder steps 0 -> 1 -> 2, then back up), two at
    tick 5, then every 5th dispatch. Returns per-wire egress, the
    injector's counters and the ladder's history."""
    chaos = PKGS[pkg][3]
    sc = build(pkg, CHAOS_PROPS, depth=depth)
    plane = sc.plane
    plane.degrade_after = 2
    plane.promote_after_s = 0.0
    inj = chaos.ChaosInjector(seed=5)
    plane.attach_chaos(inj)
    rng = np.random.default_rng(2)
    got = [[] for _ in sc.wout]
    levels, failed = [], 0
    for t in range(CHAOS_FEED + CHAOS_DRAIN):
        if faults and t in (2, 5):
            inj.fail_next_dispatches(4 if t == 2 else 2)
        if faults and t == 8:
            inj.fail_every_kth_dispatch(5)
        if t < CHAOS_FEED:
            for k, w in enumerate(sc.win):
                w.ingress.extend(frames_for(k, t, CHAOS_COUNTS[k], rng))
        for _attempt in range(6):  # a failed tick is retried at once
            try:
                plane.tick(now_s=(t + 1) * DT)
                plane._supervise(True)
                levels.append(plane.degrade_level)
                break
            except chaos.ChaosError:
                failed += 1
                plane._supervise(False)
                levels.append(plane.degrade_level)
        for k, w in enumerate(sc.wout):
            while w.egress:
                got[k].append(w.egress.popleft())
    plane.flush()
    assert not plane._pending and plane.tick_errors == 0
    return {"got": got, "injected": dict(inj.injected), "failed": failed,
            "levels": levels, "degradations": plane.degradations,
            "promotions": plane.promotions, "shaped": plane.shaped}


@pytest.mark.chaos
@pytest.mark.parametrize("depth", [1, 2])
def test_dispatch_faults_requeue_and_walk_the_ladder(depth):
    """Forced dispatch failures requeue their frames and step the ladder
    down and back up; per-wire egress is byte for byte a no-fault run's,
    and the whole history equals the JAX plane's."""
    t = chaos_run("torch", depth, faults=True)
    j = chaos_run("jax", depth, faults=True)
    clean = chaos_run("torch", depth, faults=False)
    assert t == j
    assert t["got"] == clean["got"]
    assert t["shaped"] == sum(CHAOS_COUNTS) * CHAOS_FEED
    assert t["injected"]["dispatch"] == t["failed"] >= 5
    assert max(t["levels"]) == 2 and t["levels"][-1] == 0
    assert t["degradations"] == t["promotions"] >= 2


def test_attach_chaos_wraps_peer_rpcs():
    """attach_chaos installs the injector on the daemon's peer-client
    factory (every peer RPC is gated) and on the dispatch hook."""
    sc = build("torch", CHAOS_PROPS[:1])
    calls = []

    class Client:
        def SendToOnce(self, *a, **k):
            calls.append("SendToOnce")

    sc.daemon.engine._peer_clients["b:1"] = Client()
    inj = tchaos.ChaosInjector(seed=1)
    sc.plane.attach_chaos(inj)
    assert sc.plane.chaos is inj
    sc.daemon._peer_wire_client("b:1").SendToOnce()
    inj.blackhole_peer("b:1")
    with pytest.raises(grpc.RpcError) as e:
        sc.daemon._peer_wire_client("b:1").SendToOnce()
    assert e.value.code() == grpc.StatusCode.UNAVAILABLE
    assert calls == ["SendToOnce"] and inj.injected["peer_blackhole"] == 1
    sc.plane.attach_chaos(inj)  # idempotent per daemon
    inj.heal_peer("b:1")
    sc.daemon._peer_wire_client("b:1").SendToOnce()
    assert calls == ["SendToOnce"] * 2


def test_kill_plane_stops_without_flush():
    sc = build("torch", CHAOS_PROPS[:1])
    inj = tchaos.ChaosInjector()
    inj.kill_plane(type("H", (), {"plane": sc.plane,
                                  "daemon": sc.daemon})())
    assert sc.plane._stop.is_set() and sc.daemon.chaos_dead
    assert inj.injected["plane_kill"] == 1


def test_copy_of_chaos_module_matches():
    """The port's chaos.py is the JAX module's API: every public name."""
    pub = lambda m: sorted(n for n in dir(m) if not n.startswith("__"))
    assert pub(tchaos) == pub(jchaos)
    assert pub(tchaos.ChaosInjector) == pub(jchaos.ChaosInjector)
