"""Tracing/profiling — phase timing as a first-class subsystem.

The reference's tracing is ad-hoc: fmt.Printf phase walltimes in the
controller (reference controllers/topology_controller.go:99-153) and
Prometheus latency histograms in the daemon (daemon/metrics/
latency_histograms.go). This module upgrades that to a structured tracer:

- nested spans with a thread-local stack (`with tracer.span("add-links"):`)
- chrome://tracing ("catapult") JSON export, loadable in Perfetto
- per-name aggregate stats (count/total/max ms), the histogram feed
- optional device profiling via torch.profiler for the card's hot path

A process-wide default tracer keeps call sites one-liners; everything is
thread-safe.

Port of kubedtn_tpu/utils/tracing.py. The host tracer is the same code
and writes the same catapult events; `device_trace` captures through
torch.profiler (host ops, and the card's kernels where CUDA is present)
instead of jax.profiler, and writes a Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start_us: float
    dur_us: float = 0.0
    depth: int = 0
    thread: int = 0
    meta: dict = field(default_factory=dict)


class Tracer:
    def __init__(self, enabled: bool = True,
                 max_spans: int = 100_000) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        # bounded: a long-lived daemon with spans around every
        # reconcile/checkpoint must not grow without limit — the oldest
        # spans fall off and `dropped_spans` records how many
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self.dropped_spans = 0
        self._local = threading.local()
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _stack(self) -> list[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if not self.enabled:
            yield None
            return
        s = Span(name=name, start_us=self._now_us(),
                 depth=len(self._stack()),
                 thread=threading.get_ident(), meta=meta)
        self._stack().append(s)
        try:
            yield s
        finally:
            self._stack().pop()
            s.dur_us = self._now_us() - s.start_us
            with self._lock:
                if len(self._spans) == self._spans.maxlen:
                    self.dropped_spans += 1
                self._spans.append(s)

    def add_span(self, name: str, dur_s: float, **meta) -> None:
        """Record an externally timed, already-finished span ending now
        — the pause ledger's record() path (GC callbacks, compact,
        jit-compile stalls measure their own duration and report after
        the fact). Depth 0: retro spans have no live stack to nest in.
        """
        if not self.enabled:
            return
        dur_us = dur_s * 1e6
        s = Span(name=name, start_us=self._now_us() - dur_us,
                 dur_us=dur_us, thread=threading.get_ident(), meta=meta)
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped_spans += 1
            self._spans.append(s)

    def traced(self, name: str | None = None):
        """Decorator form of span()."""

        def wrap(fn):
            label = name or fn.__qualname__

            def inner(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)

            inner.__name__ = fn.__name__
            inner.__qualname__ = fn.__qualname__
            inner.__doc__ = fn.__doc__
            return inner

        return wrap

    # -- readouts ------------------------------------------------------

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def pending(self) -> int:
        """Buffered (not yet rotated) span count — the rotation
        sidecar's size trigger, without copying the deque."""
        with self._lock:
            return len(self._spans)

    def stats(self) -> dict[str, dict[str, float]]:
        """Aggregate per-name {count, total_ms, max_ms} — the shape the
        daemon's latency histograms consume."""
        agg: dict[str, dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        for s in self.spans():
            a = agg[s.name]
            a["count"] += 1
            ms = s.dur_us / 1e3
            a["total_ms"] += ms
            a["max_ms"] = max(a["max_ms"], ms)
        return dict(agg)

    @staticmethod
    def _chrome_event(s: Span) -> dict:
        return {
            "name": s.name, "ph": "X", "ts": s.start_us, "dur": s.dur_us,
            "pid": 0, "tid": s.thread % 1_000_000, "args": s.meta,
        }

    def export_chrome(self, path: str) -> None:
        """Write catapult trace-event JSON (open in Perfetto/chrome)."""
        events = [self._chrome_event(s) for s in self.spans()]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    def rotate_out(self, path: str) -> int:
        """Crash-safe incremental export: APPEND the buffered spans to
        `path` in trace-event JSON *Array* Format and truncate the
        buffer, returning the spans written. The array format's
        closing "]" is explicitly optional (catapult/Perfetto
        importers parse a cut-off file), so a daemon rotating on an
        interval bounds what a SIGKILL can lose to one rotation — the
        dump-only-on-stop export_chrome lost the ENTIRE buffer on any
        crash. Each rotation drains-and-clears atomically under the
        tracer lock; spans recorded during the disk write land in the
        next rotation. Interleave-safe with itself but callers should
        rotate from ONE sidecar thread per file."""
        with self._lock:
            if not self._spans:
                return 0
            spans = list(self._spans)
            self._spans.clear()
        first = True
        try:
            first = os.path.getsize(path) == 0
        except OSError:
            pass
        with open(path, "a") as f:
            out = []
            for s in spans:
                out.append(("[\n" if first else ",\n")
                           + json.dumps(self._chrome_event(s)))
                first = False
            f.write("".join(out))
            f.flush()
            os.fsync(f.fileno())
        return len(spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


def stage_shares(stage_s: dict[str, float]) -> dict:
    """Cumulative per-stage seconds → {seconds, share} readout: the
    shape every stage-timing consumer (the data plane's
    stage_breakdown(), the metrics exporter) reports. share is each
    stage's fraction of total ACCOUNTED time, 0.0 when nothing has been
    timed yet."""
    total = sum(stage_s.values())
    return {
        "seconds": {k: round(v, 4) for k, v in stage_s.items()},
        "share": {k: (round(v / total, 3) if total > 0 else 0.0)
                  for k, v in stage_s.items()},
    }


# process-wide default
_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def span(name: str, **meta):
    return _default.span(name, **meta)


def traced(name: str | None = None):
    return _default.traced(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Kineto profiler capture around a region, written on exit as a
    Chrome trace (`<host>_<pid>.<ms>.pt.trace.json`, the name
    TensorBoard's handler gives it; Perfetto-loadable) into `log_dir`:
    where CUDA is present the card's kernels and memcpys and the CUDA
    runtime calls of every thread, and the host ops of the thread that
    opened it (torch records ops on that thread only). The device-side
    complement of the host spans. It is torch.autograd.profiler.profile,
    the profiler torch.profiler.profile wraps, whose start imports
    torch._inductor, seconds a process. Yields the profiler."""
    import socket

    import torch
    from torch.autograd import profiler

    os.makedirs(log_dir, exist_ok=True)
    prof = profiler.profile(
        use_device="cuda" if torch.cuda.is_available() else None,
        use_kineto=True)
    try:
        with prof:
            yield prof
    finally:
        if prof.kineto_results is not None:
            prof.export_chrome_trace(os.path.join(
                log_dir, f"{socket.gethostname()}_{os.getpid()}."
                         f"{time.time_ns() // 1_000_000}.pt.trace.json"))
