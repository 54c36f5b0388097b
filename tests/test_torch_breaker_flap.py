"""Cross-node egress under a flapping peer: both packages' per-peer
sender (runtime._PeerSender) driven through the same square-wave flap,
on one virtual clock, compared breaker open for breaker open.

chip_smoke.py's phase 13(c) flaps node B (ChaosInjector.flap_peer: 50 ms
period, down the first half) and checks that node A's breaker opened at
least once; that check failed once on the card with 0 opens. This file
asks whether the port's sender opens its breaker on other occasions than
the JAX package's. Both senders run the daemon's defaults (breaker: 3
consecutive failures open it, a 0.25 s cooldown that doubles; backoff:
50 ms doubling, jitter in [0.5, 1.0]), each package's ChaosInjector
gating every RPC, and one virtual clock for the breaker and the flap:
a retry's backoff and a parked breaker's wait advance it instead of
sleeping, and every read advances it 1 ms (the sender's own work), so
the timeline depends on the order of the calls alone. The backoff jitter
is seeded.

Finding: the two packages open, half-open and close their breakers on
the same calls for every flap phase and jitter seed here. Whether the
breaker opens at all depends on where the sends land in the flap: with
ticks a whole number of flap periods apart, a tick whose send falls in
the up half never fails (0 opens); one in the down half opens the
breaker only when both retries land in down halves too. On the card
the jitter is unseeded and the phase is the wall clock's, so 13(c)'s
`opens >= 1` was a timing property of the check, not a fault of the port.
So 13(c) now takes B down from the start until A's breaker has opened and
flaps it from then on; the last test here holds that feed in both
packages.
"""

import random
import threading
import time

import pytest

import kubedtn_tpu.chaos as jchaos
import kubedtn_tpu.fault as jfault
import kubedtn_tpu.runtime as jrt
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu_torch.chaos as tchaos
import kubedtn_tpu_torch.fault as tfault
import kubedtn_tpu_torch.runtime as trt
import kubedtn_tpu_torch.wire.proto as tpb

from test_torch_fault_domains import (WAIT_S, FakeDaemon, ScriptedClient,
                                      _packets)

PKGS = {"jax": (jrt, jfault, jpb, jchaos),
        "torch": (trt, tfault, tpb, tchaos)}
FLAP = (0.05, 0.5)     # chip_smoke.XN_FLAP: period (s), share down
TICK_S = 1.0           # a 13(c) tick on the card takes about a second
TICKS = 16             # chip_smoke.XN_EQ_TICKS
READ_S = 0.001         # virtual seconds each clock read costs
PEER = "peer:1"


class VClock:
    """Virtual seconds: each read costs READ_S; waits are jumps."""

    def __init__(self) -> None:
        self.t = 0.0
        self._l = threading.Lock()

    def __call__(self) -> float:
        with self._l:
            self.t += READ_S
            return self.t

    def advance(self, dt: float) -> None:
        with self._l:
            self.t += max(dt, 0.0)

    def at_least(self, t: float) -> None:
        with self._l:
            self.t = max(self.t, t)


def flap_run(pkg: str, phase_s: float, seed: int,
             outage: bool = False) -> dict:
    """TICKS ticks of 4 frames TICK_S apart through `pkg`'s sender, the
    peer flapping from t0 = -phase_s on the virtual clock. With `outage`,
    as chip_smoke.py's 13(c) feeds it, the peer is down from the start
    until the breaker has opened, and flaps from then on (phase_s behind
    that moment). Returns the sender's and breaker's counters and the
    RPC outcomes."""
    rt, fault, pb, chaos = PKGS[pkg]
    clock = VClock()

    class VBackoff(fault.Backoff):
        def next_delay(self) -> float:
            clock.advance(super().next_delay())
            return 0.0

    client = ScriptedClient([])
    d = FakeDaemon(client)
    inj = chaos.ChaosInjector(seed=13, clock=clock)
    inj.install_peer_faults(d)
    if outage:
        inj.blackhole_peer(PEER)
    else:
        inj.flap_peer(PEER, *FLAP, t0=-phase_s)
    breaker = fault.CircuitBreaker(clock=clock)
    to_probe = breaker.time_to_probe

    def jump_to_probe() -> float:
        clock.advance(to_probe())
        return 0.0

    breaker.time_to_probe = jump_to_probe
    s = rt._PeerSender(d, PEER, breaker=breaker,
                       backoff=VBackoff(rng=random.Random(seed)))
    try:
        for k in range(TICKS):
            clock.at_least(k * TICK_S)
            s.enqueue(_packets(pb, 4, 4 * k))
            if outage:
                deadline = time.monotonic() + WAIT_S
                while s.breaker.opens == 0 and time.monotonic() < deadline:
                    time.sleep(0.001)
                assert s.breaker.opens >= 1, "the outage never opened it"
                inj.heal_peer(PEER)
                inj.flap_peer(PEER, *FLAP, t0=clock.t - phase_s)
                outage = False
            assert s.wait_empty(WAIT_S)
        b = s.breaker
        return {"opens": b.opens, "half_opens": b.half_opens,
                "closes": b.closes, "state": b.state, "retries": s.retries,
                "sent": s.sent, "dropped": s.dropped,
                "forward_errors": d.forward_errors,
                "blackholed": inj.injected["peer_blackhole"],
                "calls": [c[2] for c in client.calls],
                "got": client.got}
    finally:
        s.stop(WAIT_S)


PHASES = [0.0, 0.01, 0.02, 0.03, 0.04]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("phase_s", PHASES)
def test_breaker_opens_equal_jax_under_the_flap(phase_s, seed):
    j = flap_run("jax", phase_s, seed)
    t = flap_run("torch", phase_s, seed)
    assert t == j
    # every frame delivered in order: the outage buffer holds them
    assert t["sent"] == 4 * TICKS and t["forward_errors"] == 0
    assert t["got"] == [i.to_bytes(4, "big") * 10
                        for i in range(4 * TICKS)]
    assert t["retries"] == t["blackholed"]


def test_whether_the_breaker_opens_is_the_flap_phase_and_the_jitter():
    """With ticks a whole number of flap periods apart, the send of every
    tick lands at the same flap phase: in the up half nothing fails and
    the breaker never opens; in the down half every tick's first send
    fails, and the breaker opens only when the two retries land in down
    halves too, which the jitter decides: at phase 0 jitter seed 0 gives
    16 failing ticks and no open, seed 2 nine opens."""
    up = flap_run("torch", 0.03, 0)      # sends land 30-31 ms in: up
    assert up["blackholed"] == 0 and up["opens"] == 0
    none, some = flap_run("torch", 0.0, 0), flap_run("torch", 0.0, 2)
    assert none["blackholed"] >= TICKS and none["opens"] == 0
    assert some["blackholed"] >= TICKS and some["opens"] == 9
    assert none["retries"] >= TICKS and none["forward_errors"] == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("phase_s", PHASES)
def test_an_outage_before_the_flap_opens_the_breaker(pkg, phase_s, seed):
    """chip_smoke.py's 13(c) feed: B down until A's breaker has opened,
    then the flap. At every flap phase and jitter seed, including the
    ones where the flap alone never opens it (phase 0, seed 0 and phase
    30 ms above), the breaker opens, closes again once the peer answers,
    and every frame arrives once and in order, in both packages."""
    r = flap_run(pkg, phase_s, seed, outage=True)
    assert r["opens"] >= 1 and r["retries"] >= 1
    assert r["closes"] >= 1 and r["state"] == 0
    assert r["sent"] == 4 * TICKS and r["forward_errors"] == 0
    assert r["dropped"] == 0 and r["retries"] == r["blackholed"]
    assert r["got"] == [i.to_bytes(4, "big") * 10
                        for i in range(4 * TICKS)]
