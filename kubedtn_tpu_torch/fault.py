"""Fault-domain primitives: circuit breaker, retry backoff, rate-limited
logging.

The reference's crash story is *reconstruction* (a restarted daemon
re-lists Topology CRs and rebuilds its managers, reference
daemon/kubedtn/kubedtn.go:107-121); transient peer failures it simply
drops and counts (grpcwire.go:452-459). This build carries mutable
in-flight state a reconstruction cannot recover — delay lines, token
buckets, the dispatch ring — so the data plane needs the failure posture
of a real network device instead: bounded retry with backoff for
transient peer errors, a per-peer circuit breaker so a dead peer costs
O(1) probes instead of a retry storm, and supervision that degrades the
tick pipeline rather than losing frames. These are the shared pieces;
runtime.py wires them into the per-peer senders and the runner thread.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable

from kubedtn_tpu_torch.contracts import guarded_by

# CircuitBreaker states (exported through kubedtn_peer_breaker_state).
CLOSED = 0
OPEN = 1
HALF_OPEN = 2

STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half-open"}


class CircuitBreaker:
    """Per-peer circuit breaker: closed → open after `failure_threshold`
    consecutive failures → one half-open probe after `reset_timeout_s` →
    closed on probe success, back to open (with a doubled timeout, capped)
    on probe failure.

    Single-owner by design: one sender thread drives allow()/record_*, so
    no internal lock is needed; readers (metrics scrapes) see torn but
    monotonic counters at worst. `clock` is injectable for deterministic
    tests."""

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 0.25,
                 max_reset_timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.base_reset_timeout_s = float(reset_timeout_s)
        self.max_reset_timeout_s = float(max_reset_timeout_s)
        self._clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self._open_until = 0.0
        self._timeout_s = self.base_reset_timeout_s
        # cumulative transition counters (metrics)
        self.opens = 0        # (closed|half-open) -> open
        self.half_opens = 0   # open -> half-open (probe granted)
        self.closes = 0       # half-open -> closed (probe succeeded)

    @property
    def cycles(self) -> int:
        """Completed open → half-open → closed recovery cycles."""
        return self.closes

    def allow(self) -> bool:
        """May the caller attempt a send now? An OPEN breaker whose reset
        timeout elapsed transitions to HALF_OPEN and grants exactly one
        probe attempt."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN and self._clock() >= self._open_until:
            self.state = HALF_OPEN
            self.half_opens += 1
            return True
        # HALF_OPEN: the probe is already in flight (single owner); OPEN:
        # still cooling down
        return self.state == HALF_OPEN

    def time_to_probe(self) -> float:
        """Seconds until an OPEN breaker grants its half-open probe
        (0.0 when sends are already allowed)."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self._open_until - self._clock())

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self.closes += 1
        self.state = CLOSED
        self.consecutive_failures = 0
        self._timeout_s = self.base_reset_timeout_s

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            # failed probe: back to open, with the cooldown escalated
            self._timeout_s = min(self._timeout_s * 2.0,
                                  self.max_reset_timeout_s)
            self._trip()
        elif (self.state == CLOSED
              and self.consecutive_failures >= self.failure_threshold):
            self._trip()

    def _trip(self) -> None:
        self.state = OPEN
        self.opens += 1
        self._open_until = self._clock() + self._timeout_s


class Backoff:
    """Exponential backoff with jitter for retry sleeps. The jitter
    multiplier is drawn from a seedable RNG (uniform in [0.5, 1.0]) so
    N senders retrying against one recovered peer do not stampede in
    phase — and chaos tests stay deterministic under a fixed seed."""

    def __init__(self, base_s: float = 0.05, factor: float = 2.0,
                 max_s: float = 2.0, rng: random.Random | None = None
                 ) -> None:
        self.base_s = base_s
        self.factor = factor
        self.max_s = max_s
        self._rng = rng if rng is not None else random.Random()
        self.attempt = 0

    def next_delay(self) -> float:
        # exponent clamped: a peer down for hours reaches thousands of
        # attempts, and float `2.0 ** 1024` raises OverflowError — the
        # delay saturates at max_s long before the clamp binds
        exp = min(self.attempt, 64)
        d = min(self.base_s * (self.factor ** exp), self.max_s)
        self.attempt += 1
        return d * (0.5 + 0.5 * self._rng.random())

    def reset(self) -> None:
        self.attempt = 0


@guarded_by("_lock", "_last", "_suppressed")
class RateLimitedLog:
    """At-most-one-log-per-interval gate. `ready()` returns (fire,
    suppressed_since_last): persistent failures at data-plane cadence
    must not emit hundreds of lines per second, but the peer address and
    status code must still reach the log."""

    def __init__(self, min_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._last = -float("inf")
        self._suppressed = 0
        self._lock = threading.Lock()

    def ready(self) -> tuple[bool, int]:
        with self._lock:
            now = self._clock()
            if now - self._last >= self.min_interval_s:
                self._last = now
                n, self._suppressed = self._suppressed, 0
                return True, n
            self._suppressed += 1
            return False, 0
