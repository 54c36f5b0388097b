"""Per-tenant admission control — host-side token buckets at ingress.

Port of kubedtn_tpu/tenancy/admission.py (host code, unchanged).

The WhatIf plane's budget/semaphore discipline (twin/query.py: bounded
work per request, refuse loudly rather than park) applied to the DATA
path: each tenant carries a frames/s and a bytes/s token bucket, and
the plane's drain stage consults them per tick. An over-budget
tenant's wires are simply not drained that tick — the frames stay on
their ingress deques (bounded by the daemon's existing high-water
backpressure), a typed ThrottleVerdict is recorded and metered, and
the bucket refills with (virtual or wall) time. Nothing is ever
silently dropped by admission.

Buckets are HOST state driven by the tick clock (`now_s`), so
explicit-clock runs (tests, fast_forward, the noisy_neighbor scenario
smoke) enforce deterministically.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

__all__ = ["HostTokenBucket", "ThrottleVerdict", "AdmissionController"]


class HostTokenBucket:
    """Classic token bucket on the caller's clock. `rate_per_s` tokens
    accrue per second up to `burst`; `charge()` debits (may overdraw —
    batch-granular admission charges what was actually drained), and
    the tenant throttles while the fill is non-positive. rate 0 means
    unlimited (never throttles, never charges)."""

    __slots__ = ("rate_per_s", "burst", "fill", "_last_s")

    def __init__(self, rate_per_s: float, burst: float | None = None,
                 ) -> None:
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst) if burst else max(self.rate_per_s, 1.0)
        self.fill = self.burst
        self._last_s: float | None = None

    def _refill(self, now_s: float) -> None:
        if self._last_s is not None and now_s > self._last_s:
            self.fill = min(self.burst,
                            self.fill + (now_s - self._last_s)
                            * self.rate_per_s)
        self._last_s = now_s if self._last_s is None \
            else max(self._last_s, now_s)

    def ok(self, now_s: float) -> bool:
        if self.rate_per_s <= 0:
            return True
        self._refill(now_s)
        return self.fill > 0.0

    def charge(self, n: float, now_s: float) -> None:
        if self.rate_per_s <= 0:
            return
        self._refill(now_s)
        self.fill -= float(n)

    def reconfigure(self, rate_per_s: float,
                    burst: float | None = None) -> None:
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst) if burst else max(self.rate_per_s, 1.0)
        self.fill = min(self.fill, self.burst)


@dataclasses.dataclass(frozen=True)
class ThrottleVerdict:
    """One typed admission refusal: which tenant, which wire, why, and
    how many frames were left queued (not dropped) at that instant."""

    tenant: str
    wire_id: int
    queued_frames: int
    reason: str          # "frame-budget" | "byte-budget"
    at_s: float


class AdmissionController:
    """Per-tenant bucket enforcement + verdict metering. One instance
    per TenantRegistry; the plane reaches it through
    `registry.drain_policy(...)` (runtime._tick_inner)."""

    VERDICT_RING = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.verdicts: deque[ThrottleVerdict] = deque(
            maxlen=self.VERDICT_RING)
        # per-tenant cumulative meters (scrape-tolerant counters)
        self.throttle_events: dict[str, int] = {}
        self.throttled_frame_ticks: dict[str, int] = {}

    def record(self, verdict: ThrottleVerdict) -> None:
        with self._lock:
            self.verdicts.append(verdict)
            t = verdict.tenant
            self.throttle_events[t] = self.throttle_events.get(t, 0) + 1
            self.throttled_frame_ticks[t] = (
                self.throttled_frame_ticks.get(t, 0)
                + verdict.queued_frames)

    def recent(self, limit: int = 50) -> list[ThrottleVerdict]:
        with self._lock:
            return list(self.verdicts)[-limit:]

    def stats_for(self, tenant: str) -> dict:
        with self._lock:
            return {
                "throttle_events": self.throttle_events.get(tenant, 0),
                "throttled_frame_ticks":
                    self.throttled_frame_ticks.get(tenant, 0),
            }
