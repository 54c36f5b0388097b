"""Pause & stall observability plane — barrier-pause attribution.

BENCH_host_scale is honest that compact() and checkpoint_save are
whole-plane stop-the-world passes, and ROADMAP.md names them the
availability ceiling for constellation churn — but in a *running*
daemon those pauses were invisible: no metric, no trace span on the
tick path, no way to answer "why did tick latency spike at 14:02".
This module is the measurement substrate the incremental
checkpoint/compact refactor will be judged against.

The contract is a lock-cheap `PauseLedger` every tick-lock barrier
site reports into:

- **Cause taxonomy** (`CAUSES`): checkpoint save/load, compact,
  staged updates, migration fork/restore/cutover, pipeline flush, shm
  batch-dequeue stalls, jit recompiles (compile seconds per shape
  bucket), and GC pauses. Each event carries its cause, duration, and
  whatever detail the site knows — rows/bytes touched, the
  tenant/plan/migration id that triggered it.
- **Per-cause aggregates**: count / seconds / max / last, plus summed
  rows and bytes, under one short-hold lock. A bounded event ring
  keeps the most recent occurrences for `kdt pauses` and the wire
  `ObservePauses` query; overflow is counted, never silent
  (`dropped_events`), matching the telemetry ring's contract.
- **Tick-latency-by-cause histograms**: the data plane times every
  public `tick()` around the tick-lock acquisition (so lock-wait
  behind a barrier holder is included) and calls `note_tick(dur_s)`;
  the ledger attributes that tick's wall latency to the DOMINANT cause
  among pauses recorded since the previous tick ("none" when the tick
  was clean) and accumulates per-cause histograms on the reference
  bucket ladder (metrics.BUCKETS, ms → seconds edges). This is the
  feed for `kubedtn_tick_latency_seconds{cause}`.
- **Tracer streaming**: every `pause()` context also opens a
  `pause:<cause>` span on the process tracer, so `--trace-out`
  Perfetto dumps show barriers on the tick timeline next to the
  reconcile/checkpoint spans that caused them.
- **A/B switch**: `enabled=False` turns every hook into a
  near-zero-cost branch — the `pause_observability` bench phase
  measures the on/off delta on the plane-only probe and holds it
  under 2% (the `savail` budget's `hook_overhead_pct`).

Thread model: `record()`/`pause()` may be called from any thread (GC
callbacks land on whoever triggered collection); `note_tick()` is
tick-thread only. One plain Lock, held for dict arithmetic only —
never across a barrier, an allocation burst, or a device sync.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from kubedtn_tpu_torch.telemetry import BUCKETS

# Canonical cause taxonomy — every barrier site reports one of these.
# (An unknown cause is still recorded — the metrics cardinality cap and
# the savail "unbudgeted cause" check are the guards — but sites should
# stay on-taxonomy so budgets and docs line up.)
CAUSES = (
    "checkpoint_save",
    "checkpoint_load",
    "compact",
    "staged_update",
    "migration_fork",
    "migration_restore",
    "migration_cutover",
    "pipeline_flush",
    "shm_stall",
    "jit_compile",
    "gc",
)

# Tick-latency bucket upper edges in SECONDS — the reference daemon's
# request-duration ladder (metrics.BUCKETS, milliseconds) rescaled, one
# overflow bin at the end.
TICK_EDGES_S = tuple(float(b) / 1000.0 for b in BUCKETS[1:])
N_TICK_BINS = len(TICK_EDGES_S) + 1


class PauseLedger:
    """Thread-safe per-cause pause accounting (see module docstring)."""

    def __init__(self, max_events: int = 2048, tracer=None,
                 enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        # cause -> [count, seconds, max_s, last_s, last_t, rows, bytes]
        self._agg: dict[str, list[float]] = {}
        self._events: deque[dict] = deque(maxlen=max_events)
        self.dropped_events = 0
        # cause -> seconds since the last note_tick() — the attribution
        # window for tick-latency-by-cause
        self._since_tick: dict[str, float] = {}
        # cause -> [N_TICK_BINS] bucket counts (+ count/sum for the
        # Prometheus histogram exposition)
        self._tick_hist: dict[str, list[int]] = {}
        self._tick_count: dict[str, int] = {}
        self._tick_sum: dict[str, float] = {}
        self._t0 = time.monotonic()
        self._tracer = tracer

    # -- recording ------------------------------------------------------

    @contextlib.contextmanager
    def pause(self, cause: str, **detail):
        """Time a barrier region and record it under `cause`.

        Detail keys are free-form; `rows=` and `bytes=` feed the
        per-cause touched totals, ids (tenant/plan/migration) ride the
        event ring. The span lands via record() below.
        """
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(cause, time.perf_counter() - t0, **detail)

    def record(self, cause: str, dur_s: float, **detail) -> None:
        """Record one timed pause (any thread: the pause() exit path,
        the GC callback, a site that measured its own region). Streams
        a `pause:<cause>` span onto the process tracer so `--trace-out`
        Perfetto dumps show the barrier on the tick timeline."""
        if not self.enabled:
            return
        dur_s = float(dur_s)
        now = time.monotonic() - self._t0
        rows = float(detail.get("rows", 0) or 0)
        nbytes = float(detail.get("bytes", 0) or 0)
        with self._lock:
            a = self._agg.get(cause)
            if a is None:
                a = self._agg[cause] = [0.0, 0.0, 0.0, 0.0, 0.0,
                                        0.0, 0.0]
            a[0] += 1.0
            a[1] += dur_s
            if dur_s > a[2]:
                a[2] = dur_s
            a[3] = dur_s
            a[4] = now
            a[5] += rows
            a[6] += nbytes
            self._since_tick[cause] = \
                self._since_tick.get(cause, 0.0) + dur_s
            if len(self._events) == self._events.maxlen:
                self.dropped_events += 1
            ev = {"cause": cause, "dur_s": round(dur_s, 6),
                  "t_s": round(now, 3)}
            if detail:
                ev.update({k: v for k, v in detail.items()
                           if v is not None})
            self._events.append(ev)
        tracer = self._tracer
        if tracer is None:
            from kubedtn_tpu_torch.utils.tracing import default_tracer
            tracer = self._tracer = default_tracer()
        tracer.add_span(f"pause:{cause}", dur_s, **detail)

    def note_tick(self, dur_s: float) -> None:
        """Attribute one tick's wall latency (lock-wait included) to
        the dominant cause recorded since the previous tick, and fold
        it into that cause's latency histogram. Tick thread only."""
        if not self.enabled:
            return
        with self._lock:
            if self._since_tick:
                cause = max(self._since_tick,
                            key=self._since_tick.get)
                self._since_tick.clear()
            else:
                cause = "none"
            h = self._tick_hist.get(cause)
            if h is None:
                h = self._tick_hist[cause] = [0] * N_TICK_BINS
                self._tick_count[cause] = 0
                self._tick_sum[cause] = 0.0
            i = 0
            for edge in TICK_EDGES_S:
                if dur_s <= edge:
                    break
                i += 1
            h[i] += 1
            self._tick_count[cause] += 1
            self._tick_sum[cause] += dur_s

    # -- readouts -------------------------------------------------------

    def causes(self) -> dict[str, dict[str, float]]:
        """Per-cause aggregate snapshot, one lock hold. Shape:
        {cause: {count, seconds, max_s, last_s, last_t_s, rows,
        bytes}}."""
        with self._lock:
            return {
                c: {"count": int(a[0]), "seconds": a[1], "max_s": a[2],
                    "last_s": a[3], "last_t_s": a[4],
                    "rows": int(a[5]), "bytes": int(a[6])}
                for c, a in self._agg.items()
            }

    def events(self, n: int = 50) -> list[dict]:
        """The most recent `n` events, oldest first."""
        with self._lock:
            evs = list(self._events)
        return evs[-n:] if n >= 0 else evs

    def tick_hist(self) -> dict[str, dict]:
        """Per-cause tick-latency histograms: {cause: {buckets: [...],
        count, sum_s}} on the TICK_EDGES_S ladder."""
        with self._lock:
            return {
                c: {"buckets": list(h), "count": self._tick_count[c],
                    "sum_s": self._tick_sum[c]}
                for c, h in self._tick_hist.items()
            }

    def snapshot(self) -> dict:
        """Everything the wire/metrics/bench surfaces consume, in one
        consistent read: aggregates, histograms, uptime, ring health."""
        with self._lock:
            causes = {
                c: {"count": int(a[0]), "seconds": round(a[1], 6),
                    "max_s": round(a[2], 6), "last_s": round(a[3], 6),
                    "last_t_s": round(a[4], 3),
                    "rows": int(a[5]), "bytes": int(a[6])}
                for c, a in self._agg.items()
            }
            hist = {
                c: {"buckets": list(h), "count": self._tick_count[c],
                    "sum_s": round(self._tick_sum[c], 6)}
                for c, h in self._tick_hist.items()
            }
            dropped = self.dropped_events
        return {
            "enabled": self.enabled,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "causes": causes,
            "tick_hist": hist,
            "tick_edges_s": list(TICK_EDGES_S),
            "dropped_events": dropped,
        }

    def total_pause_s(self) -> float:
        with self._lock:
            return sum(a[1] for a in self._agg.values())

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._events.clear()
            self._since_tick.clear()
            self._tick_hist.clear()
            self._tick_count.clear()
            self._tick_sum.clear()
            self.dropped_events = 0
            self._t0 = time.monotonic()
