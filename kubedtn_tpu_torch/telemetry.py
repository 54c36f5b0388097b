"""Link telemetry, device half: the per-edge window accumulator's layout
and the fold the live tick runs on every shaped class group.

Port of kubedtn_tpu/telemetry.py's device functions (`tel_matrix`,
`tel_accumulate`) and of the constants they and their readers share. The
host half (LinkTelemetry's window ring, the FlightRecorder) belongs to
the host live plane and comes with it.

The open window is an `[E, KCOLS]` float32 accumulator chained through
the tick like the dynamic edge-state columns. Each class group adds one
`[R, KCOLS]` row contribution at its rows with one row-indexed
`index_add_`. Rows are unique within a class group (padding rows, index
E, land on an extra row that is cut off), so every real row takes one
add per group: the sum is exact whatever order CUDA's atomics take.

The latency buckets are the reference daemon's request-duration ladder
(milliseconds) scaled to µs, with one overflow bin.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from kubedtn_tpu_torch.contracts import guarded_by
from kubedtn_tpu_torch.ops.netem import scatter_rows

# The reference's bucket edges in ms (reference latency_histograms.go:15);
# a copy of kubedtn_tpu.metrics.metrics.BUCKETS.
BUCKETS = (0, 1, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)

# Latency histogram bin upper edges in µs; one overflow bin at the end.
BUCKET_EDGES_US = tuple(float(b) * 1000.0 for b in BUCKETS[1:])
N_BINS = len(BUCKET_EDGES_US) + 1

# -- window column layout (the K axis of the [W, E, K] ring) -----------
T_TX = 0           # slots offered to the shaping kernels
T_DELIVERED = 1    # left the qdisc chain
T_BYTES = 2        # delivered bytes
T_DROP_LOSS = 3    # netem loss
T_DROP_QUEUE = 4   # TBF 50ms-queue overflow
T_CORRUPT = 5      # delivered but corrupt-flagged
T_LAT_SUM_US = 6   # sum of delivered shaping latency (µs)
T_QDEPTH = 7       # frames deferred to the holdback buffer (host-side)
T_HIST0 = 8        # first latency bucket; N_BINS buckets follow
KCOLS = T_HIST0 + N_BINS

COLUMN_NAMES = ("tx", "delivered", "bytes", "dropped_loss",
                "dropped_queue", "corrupted", "latency_sum_us",
                "queue_depth") + tuple(
                    f"lat_le_{int(e / 1000)}ms" for e in BUCKET_EDGES_US
                ) + ("lat_overflow",)

# -- per-slot cause codes (see ops/netem.cause_codes) ------------------
CAUSE_INVALID = 0    # padding / inactive lane
CAUSE_DELIVERED = 1
CAUSE_LOSS = 2       # netem loss
CAUSE_QUEUE = 3      # TBF queue overflow
CAUSE_NAMES = {CAUSE_INVALID: "invalid", CAUSE_DELIVERED: "delivered",
               CAUSE_LOSS: "dropped_loss", CAUSE_QUEUE: "dropped_queue"}


def init_acc(capacity: int, device) -> torch.Tensor:
    """A zero `[capacity, KCOLS]` open window on `device`."""
    return torch.zeros((capacity, KCOLS), dtype=torch.float32,
                       device=device)


_EDGES: dict = {}


def _bucket_edges(device) -> torch.Tensor:
    """BUCKET_EDGES_US as a float32 tensor on `device`, made once per
    device: the tick path must not copy it from the host every time (a
    copy from pageable memory waits for the kernels queued on the
    stream, which would serialise the plane's pipeline)."""
    e = _EDGES.get(device)
    if e is None:
        # dtnlint: purity-ok(a per-device cache of the constant bucket edges: every call returns the same values)
        e = _EDGES[device] = torch.tensor(BUCKET_EDGES_US,
                                          dtype=torch.float32,
                                          device=device)
    return e


def tel_matrix(sizes, valid, res, row_counts=None) -> torch.Tensor:
    """The per-row `[R, KCOLS]` window contribution of one shaped group:
    the compute half of `tel_accumulate`, computed replicated by every
    shard of the sharded tick, each of which adds only its owned rows."""
    f32 = torch.float32
    deliv = res.delivered.to(f32)
    vald = valid.to(f32)
    # delivered lanes' depart is finite, dropped lanes are +inf: the
    # where() keeps inf out of the sums (inf * 0 would be nan)
    lat = torch.where(res.delivered, res.depart_us, 0.0)
    if row_counts is not None:
        loss_r, queue_r, corr_r = row_counts
    else:
        loss_r = res.dropped_loss.to(f32).sum(1)
        queue_r = res.dropped_queue.to(f32).sum(1)
        corr_r = res.corrupted.to(f32).sum(1)
    # per-row CUMULATIVE bucket counts from `lat` (0 on non-delivered
    # lanes, which all land at 0 <= edge_j, so subtracting the per-row
    # non-delivered count corrects every cumulative at once); per-bin
    # counts are first differences, the overflow bin the remainder
    edges = _bucket_edges(lat.device)
    deliv_total = deliv.sum(1)
    not_deliv = float(res.delivered.shape[1]) - deliv_total
    cum = ((lat[..., None] <= edges).sum(dim=1).to(f32)
           - not_deliv[:, None])                          # [R, 11]
    hist = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1],
                      (deliv_total - cum[:, -1])[:, None]], dim=1)
    return torch.cat([torch.stack([
        vald.sum(1),
        deliv_total,
        (sizes * deliv).sum(1),
        loss_r,
        queue_r,
        corr_r,
        lat.sum(1),
        torch.zeros_like(deliv_total),             # T_QDEPTH: host-side
    ], dim=1), hist], dim=1)                       # [R, KCOLS]


def tel_accumulate(acc, row_idx, sizes, valid, res, row_counts=None):
    """Fold one shaped group into the open window `acc` ([E, KCOLS]):
    ONE row-indexed index_add_ of `tel_matrix`; rows >= E (padding)
    drop. `res` is the group's ShapeResult ([R, K] leaves); `row_counts`
    the tick's (loss[R], queue[R], corrupt[R]) sums, reused when given.
    Returns a NEW accumulator; `acc` is not modified."""
    mat = tel_matrix(sizes, valid, res, row_counts=row_counts)
    return scatter_rows(acc, row_idx, mat, add=True)


# -- host half -------------------------------------------------------------

def tel_row_host(sizes, valid, delivered, depart_us) -> np.ndarray:
    """Host-side twin of `tel_accumulate` for ONE row: the `[KCOLS]`
    contribution of (sizes[K], valid[K], delivered[K], depart_us[K]).
    Used to patch windows for the rare TBF-fallback re-shapes, whose
    exact results only exist host-side at completion (the device
    accumulation masked those rows out / saw stale results).
    `dropped_loss`/`dropped_queue`/`corrupted` legs are passed by the
    caller via `extra` columns because the fallback path only has the
    per-row sums."""
    out = np.zeros(KCOLS, np.float64)
    v = np.asarray(valid, bool)
    d = np.asarray(delivered, bool) & v
    dep = np.asarray(depart_us, np.float64)
    out[T_TX] = v.sum()
    out[T_DELIVERED] = d.sum()
    out[T_BYTES] = float(np.asarray(sizes, np.float64)[d].sum())
    lat = dep[d]
    out[T_LAT_SUM_US] = float(lat.sum())
    if lat.size:
        bidx = np.minimum(np.searchsorted(BUCKET_EDGES_US, lat,
                                          side="left"), N_BINS - 1)
        np.add.at(out, T_HIST0 + bidx, 1.0)
    return out


def quantile_label(q: float) -> str:
    """Stable dict-key stem for a quantile: 0.5 → "p50", 0.99 → "p99",
    0.999 → "p99_9". The historical `int(q * 100)` naming is preserved
    for every quantile it could represent; finer quantiles (the SLO
    plane's p99.9 / p99.99) get an unambiguous suffix instead of
    silently colliding with p99."""
    s = f"{q * 100:.10g}"
    return "p" + s.replace(".", "_")


def percentiles_from_hist(hist_row: np.ndarray,
                          qs=(0.5, 0.9, 0.99)) -> dict:
    """histogram_quantile over the reference bucket ladder: linear
    interpolation inside a bin, None when the histogram is empty. The
    ONE percentile implementation shared by the what-if plane's sweep
    metrics (twin/engine.py) and the link telemetry query surface.

    CENSORING: the top bucket is OPEN (everything slower than the last
    edge lands there), so a quantile whose target mass falls inside it
    is unknowable from the histogram alone — Prometheus semantics CLAMP
    it to the last edge, which silently UNDERSTATES the tail. The clamp
    is kept (callers compare against historical series), but every
    quantile now carries a companion `<p>_censored` flag: True means
    "the real value is ≥ this, render it `>Xms`, never X". The SLO
    plane's `slo.tail.estimate_quantile` fits the upper buckets'
    log-survival slope to estimate PAST the edge when the flag would
    be set (ARCHITECTURE.md "SLO plane")."""
    edges = np.asarray(BUCKET_EDGES_US)
    total = float(np.asarray(hist_row).sum())
    out = {}
    for q in qs:
        stem = quantile_label(q)
        key = f"{stem}_us"
        cens = f"{stem}_censored"
        if total <= 0:
            out[key] = None
            out[cens] = False
            continue
        target = q * total
        cum = np.cumsum(hist_row)
        b = int(np.searchsorted(cum, target, side="left"))
        if b >= len(edges):
            out[key] = float(edges[-1])
            out[cens] = True
            continue
        lo = 0.0 if b == 0 else float(edges[b - 1])
        hi = float(edges[b])
        below = 0.0 if b == 0 else float(cum[b - 1])
        inbin = float(hist_row[b])
        frac = 0.0 if inbin <= 0 else (target - below) / inbin
        out[key] = round(lo + (hi - lo) * frac, 3)
        out[cens] = False
    return out


class _Window:
    """One closed window of the ring: the device accumulator it closed
    with (materialized lazily, then the device reference is dropped)
    plus a sparse host-side patch for completion-time corrections."""

    __slots__ = ("start_s", "end_s", "dev", "patch", "_np")

    def __init__(self, start_s: float, end_s: float, dev,
                 patch: dict) -> None:
        self.start_s = start_s
        self.end_s = end_s
        self.dev = dev
        self.patch = patch  # {(row, col): float} sparse corrections
        self._np: np.ndarray | None = None

    def arr(self) -> np.ndarray:
        # lock-free against concurrent query threads (scrape +
        # ObserveLinks + cli top can all race here): read `dev` into a
        # local BEFORE the cache check resolves, publish `_np` BEFORE
        # clearing `dev` — two racers at worst both materialize the
        # same value; neither can ever see dev=None with _np unset
        a = self._np
        if a is not None:
            return a
        dev = self.dev
        if dev is None:  # another thread just finished publishing
            return self._np
        a = dev.cpu().numpy().astype(np.float64)
        for (r, c), v in self.patch.items():
            if r < a.shape[0]:
                a[r, c] += v
        self._np = a
        self.dev = None  # release device memory once drained
        return a


@guarded_by("_lock", "_acc", "_patch", "_start_s", "_now_s", "_ring",
            "windows_closed")
class LinkTelemetry:
    """The per-edge window ring's host-side controller. The plane calls
    `open_acc()` at every dispatch (under the tick lock) to fetch the
    device accumulator the fused tick chains through, and `set_acc()`
    with the dispatch's returned accumulator; window rollover happens
    inside `open_acc()` on the dispatch clock, so every dispatch's
    reductions land wholly in one window. Queries (`window_sum`,
    `link_rows`) run on other threads and only touch closed windows
    plus an immutable snapshot of the open accumulator."""

    def __init__(self, capacity: int, window_s: float = 1.0,
                 windows: int = 12, device="cpu") -> None:
        self.window_s = float(window_s)
        self.windows = int(windows)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._acc = init_acc(capacity, self.device)
        self._patch: dict = {}
        self._start_s: float | None = None
        self._now_s: float | None = None
        self._ring: deque[_Window] = deque(maxlen=self.windows)
        self.windows_closed = 0

    @property
    def capacity(self) -> int:
        with self._lock:  # _acc is swapped under the lock (rollover/grow)
            return self._acc.shape[0]

    # -- tick-path API (tick lock held by the caller) ------------------

    def open_acc(self, now_s: float, capacity: int):
        """The open window's device accumulator for this dispatch,
        rolling the window over / resizing for engine growth first. The
        returned tensor is never written in place: the tick folds into a
        NEW accumulator (tel_accumulate), so a closed window owns its
        tensor."""
        with self._lock:
            if self._acc.shape[0] != capacity:
                grown = init_acc(capacity, self.device)
                if self._acc.shape[0] < capacity:
                    grown[:self._acc.shape[0]] = self._acc
                self._acc = grown
            if self._start_s is None:
                self._start_s = now_s
            elif now_s - self._start_s >= self.window_s:
                # the closed window ENDS at the last tick observed
                # inside it, not at this (possibly much later) clock —
                # an idle gap must not inflate covered_seconds and
                # deflate the reported rates
                end = self._now_s if self._now_s is not None else now_s
                end = min(max(end, self._start_s), now_s)
                self._ring.append(_Window(self._start_s, end,
                                          self._acc, self._patch))
                self.windows_closed += 1
                self._acc = init_acc(capacity, self.device)
                self._patch = {}
                self._start_s = now_s
            self._now_s = now_s
            return self._acc

    def touch(self, now_s: float) -> None:
        """Advance the window clock on an idle tick (nothing
        dispatched): without this a quiet plane would hold one window
        open forever and rates would divide by a stale span."""
        with self._lock:
            started = self._start_s is not None
        if started:  # open_acc re-checks under the lock; a racing
            self.open_acc(now_s, self.capacity)  # first-dispatch wins

    def set_acc(self, acc) -> None:
        with self._lock:
            self._acc = acc

    def patch_add(self, row: int, col: int, val: float) -> None:
        """Sparse completion-time correction into the OPEN window (TBF
        fallback re-shapes, holdback queue depth). ±1-window attribution
        skew vs the device adds is possible when a correction lands just
        after rollover — documented, bounded, and never lost."""
        if not val:
            return
        with self._lock:
            key = (int(row), int(col))
            self._patch[key] = self._patch.get(key, 0.0) + float(val)

    def patch_row(self, row: int, cols: np.ndarray) -> None:
        for c in range(KCOLS):
            if cols[c]:
                self.patch_add(row, c, float(cols[c]))

    def remap_rows(self, old_rows, n_active: int, capacity: int) -> None:
        """Carry the ring through compact()'s row renumbering (the same
        permutation the plane applies to its cumulative counters). The
        caller has already flushed the pipeline, so materializing the
        open accumulator here is safe and rare."""
        sel = np.asarray(old_rows[:n_active], np.int64)

        def permute(a: np.ndarray) -> np.ndarray:
            out = np.zeros((capacity, KCOLS), a.dtype)
            keep = sel < a.shape[0]
            idx = np.nonzero(keep)[0]
            out[idx] = a[sel[keep]]
            return out

        with self._lock:
            # a private host copy: the patch fold-in below writes
            acc = self._acc.cpu().numpy().copy()
            for (r, c), v in self._patch.items():
                if r < acc.shape[0]:
                    acc[r, c] += v
            self._patch = {}
            self._acc = torch.as_tensor(permute(acc), device=self.device)
            for w in self._ring:
                w._np = permute(w.arr())

    # -- query API -----------------------------------------------------

    def window_sum(self, last: int | None = None,
                   include_open: bool = True):
        """(per-edge stats summed over the newest `last` closed windows
        [+ the open one], covered wall seconds). The open accumulator is
        an immutable chain head: the host copy blocks the QUERY thread
        until its value is ready, never the tick."""
        with self._lock:
            wins = list(self._ring)
            acc = self._acc if include_open else None
            patch = dict(self._patch) if include_open else {}
            start = self._start_s
            now = self._now_s
        if last is not None:
            wins = wins[-last:]
        cap = self.capacity
        total = np.zeros((cap, KCOLS), np.float64)
        seconds = 0.0
        for w in wins:
            a = w.arr()
            total[:a.shape[0]] += a[:cap]
            seconds += w.end_s - w.start_s
        if acc is not None and start is not None and now is not None:
            a = acc.cpu().numpy().astype(np.float64)
            for (r, c), v in patch.items():
                if r < a.shape[0]:
                    a[r, c] += v
            total[:a.shape[0]] += a[:cap]
            seconds += max(now - start, 0.0)
        return total, seconds

    def link_rows(self, engine, last: int | None = None,
                  limit: int = 10_000):
        """Ranked per-link rows for the query surfaces (`cli top`,
        `Local.ObserveLinks`, the `kubedtn_link_*` collector): one dict
        per realized link end with traffic in the covered windows,
        busiest first, truncated to `limit` via the engine's own
        metrics snapshot (the InterfaceStatsCollector truncation-guard
        pattern). Returns (rows, covered_seconds, truncated)."""
        total, seconds = self.window_sum(last=last)
        snapshot, total_active, _rows = engine.metrics_snapshot(
            limit=limit)
        truncated = max(0, total_active - len(snapshot))
        out = []
        secs = max(seconds, 1e-9)
        for pod_key, uid, row, _rev in snapshot:
            if row >= total.shape[0]:
                continue
            t = total[row]
            if not t[T_TX] and not t[T_QDEPTH]:
                continue
            ns, _, pod = pod_key.partition("/")
            delivered = float(t[T_DELIVERED])
            pcts = percentiles_from_hist(t[T_HIST0:],
                                         qs=(0.5, 0.99))
            out.append({
                "pod": pod, "namespace": ns, "uid": int(uid),
                "row": int(row),
                "tx": float(t[T_TX]),
                "delivered": delivered,
                "delivered_pps": delivered / secs,
                "bytes_ps": float(t[T_BYTES]) / secs,
                "dropped_loss": float(t[T_DROP_LOSS]),
                "dropped_queue": float(t[T_DROP_QUEUE]),
                "corrupted": float(t[T_CORRUPT]),
                "queue_depth": float(t[T_QDEPTH]),
                "mean_lat_us": (float(t[T_LAT_SUM_US]) / delivered
                                if delivered else None),
                "p50_us": pcts["p50_us"],
                "p99_us": pcts["p99_us"],
                # censored = the quantile clamped at the open top
                # bucket's edge (render `>Xms`, never X)
                "p99_censored": pcts["p99_censored"],
            })
        out.sort(key=lambda r: -r["delivered_pps"])
        return out, seconds, truncated


# -- sampled frame flight recorder -------------------------------------

# lifecycle stage names (the docs' state machine):
#   ingress → [bypass] → shaped → delivered | dropped
#   cross-node tail: staged-peer → [outage-buffered → retried]* →
#   peer-sent ∥ received → delivered-remote
ST_INGRESS = "ingress"
ST_BYPASS = "bypass"
ST_SHAPED = "shaped"
ST_DELIVERED = "delivered"
ST_DROPPED = "dropped"
ST_STAGED = "staged-peer"
ST_OUTAGE = "outage-buffered"
ST_RETRIED = "retried"
ST_SENT = "peer-sent"
ST_RECEIVED = "received"
ST_DELIVERED_REMOTE = "delivered-remote"
ST_REQUEUED = "requeued"
ST_EGRESS_DROP = "dropped-egress"

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
_GOLDEN64 = 0x9E3779B97F4A7C15


def _fnv64(*ints) -> int:
    """FNV-1a over the ints' bytes — init-time only (node-name hash);
    the per-frame id path uses the O(1) `_mix64`."""
    h = _FNV64_OFFSET
    for v in ints:
        v &= _MASK64
        while True:
            h = ((h ^ (v & 0xFF)) * _FNV64_PRIME) & _MASK64
            v >>= 8
            if not v:
                break
    return h


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a handful of arithmetic ops per id (the
    byte-looped FNV measured ~3µs/id in pure Python — at default
    sampling that alone was ~1% of the plane)."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


@guarded_by("_lock", "_seq", "sampled", "recorded")
class FlightRecorder:
    """Bounded host ring of lifecycle events for a deterministic sampled
    subset of frames (module docstring has the sampling contract).
    `record` is append-to-deque cheap and thread-safe (tick thread,
    per-peer sender threads, and gRPC workers all write)."""

    def __init__(self, node: str = "", sample_period: int = 256,
                 capacity: int = 65_536, seed: int = 0) -> None:
        self.node = node or "local"
        self.period = max(1, int(sample_period))
        self.seed = int(seed)
        self._node_h = _fnv64(*self.node.encode()) ^ self.seed
        self._seq: dict[int, int] = {}      # row -> frames seen
        self._lock = threading.Lock()
        self.events: deque = deque(maxlen=int(capacity))
        self.sampled = 0      # frames that entered the recorder
        self.recorded = 0     # events appended (incl. remote-origin)

    # -- sampling ------------------------------------------------------

    def _phase(self, row: int) -> int:
        return (row * 2654435761) % self.period

    def trace_id(self, row: int, seq: int) -> int:
        tid = _mix64(self._node_h ^ (row * _GOLDEN64 + seq))
        return tid or 1  # 0 means "untraced" on the wire

    def sample_batch(self, row: int, m: int) -> list[tuple[int, int]]:
        """Advance row `row`'s frame counter by `m` and return
        [(offset_in_batch, trace_id)] for the sampled frames — pure
        counter arithmetic, no per-frame work."""
        with self._lock:
            s0 = self._seq.get(row, 0)
            self._seq[row] = s0 + m
        first = (-(s0 + self._phase(row))) % self.period
        out = [(off, self.trace_id(row, s0 + off))
               for off in range(first, m, self.period)]
        if out:
            with self._lock:
                self.sampled += len(out)
        return out

    def unsample_batch(self, row: int, m: int, sampled: int) -> None:
        """Roll a sample_batch back (a failed dispatch requeues its
        undecided frames to the FRONT of their ingress deques): the
        next drain re-counts the same physical frames at the same
        global indices, so the determinism contract — and the trace
        ids already minted — replay exactly instead of double
        advancing."""
        with self._lock:
            self._seq[row] = max(0, self._seq.get(row, 0) - m)
            self.sampled -= sampled

    # -- events --------------------------------------------------------

    def record(self, trace_id: int, stage: str, **detail) -> None:
        self.events.append((trace_id, time.time(), self.node, stage,
                            detail))
        with self._lock:  # += is not atomic; writers span many threads
            self.recorded += 1

    def events_for(self, trace_id: int) -> list:
        tid = int(trace_id)
        return [e for e in list(self.events) if e[0] == tid]

    def recent_traces(self, limit: int = 50) -> list[int]:
        """Newest distinct trace ids, most recent first."""
        out: list[int] = []
        seen: set[int] = set()
        for e in reversed(list(self.events)):
            if e[0] not in seen:
                seen.add(e[0])
                out.append(e[0])
                if len(out) >= limit:
                    break
        return out

    def export(self, trace_id: int = 0, limit: int = 1000) -> list[dict]:
        """Events as dicts for the wire (trace_id=0: newest `limit`)."""
        if trace_id:
            evs = self.events_for(trace_id)
        else:
            evs = list(self.events)[-limit:]
        return [{"trace_id": t, "t": ts, "node": node, "stage": stage,
                 "detail": dict(detail)}
                for t, ts, node, stage, detail in evs[:limit]]


def merge_trace(trace_id: int, *event_sources) -> list[dict]:
    """Reconstruct one trace's hop-by-hop path from any number of
    sources (FlightRecorder instances or already-exported dict lists),
    time-ordered — the shared core of `cli trace` and the chaos-soak
    trace assertion."""
    tid = int(trace_id)
    merged: list[dict] = []
    for src in event_sources:
        if isinstance(src, FlightRecorder):
            merged.extend(src.export(tid))
        else:
            merged.extend(e for e in src if int(e["trace_id"]) == tid)
    merged.sort(key=lambda e: e["t"])
    return merged


def find_cross_node_trace(rec_a: FlightRecorder, rec_b: FlightRecorder,
                          require=(ST_INGRESS, ST_OUTAGE, ST_RETRIED,
                                   ST_SENT)) -> tuple[int, list[dict]]:
    """First sampled trace whose A-side path contains every stage in
    `require` AND that node B received — the chaos soak's proof that the
    recorder survives the fault path. Returns (trace_id, merged path),
    or (0, []) when none qualifies."""
    b_received = {e[0] for e in list(rec_b.events)
                  if e[3] in (ST_RECEIVED, ST_DELIVERED_REMOTE)}
    stages_by_tid: dict[int, set] = {}
    for e in list(rec_a.events):
        stages_by_tid.setdefault(e[0], set()).add(e[3])
    for tid, stages in stages_by_tid.items():
        if tid in b_received and all(s in stages for s in require):
            return tid, merge_trace(tid, rec_a, rec_b)
    return 0, []


def render_trace(path: list[dict], header: str | None = None) -> str:
    """Human-readable hop-by-hop rendering of a merged trace — ONE
    renderer for the in-process form (detail dicts) and the wire form
    (detail already stringified by ObserveTrace); `cli trace` and the
    chaos tooling both use it."""
    if not path:
        return "(no events)"
    t0 = path[0]["t"]
    lines = [header if header is not None
             else f"trace {path[0]['trace_id']:#018x}"]
    for e in path:
        d = e["detail"]
        det = (d if isinstance(d, str)
               else " ".join(f"{k}={v}" for k, v in sorted(d.items())))
        lines.append(f"  +{(e['t'] - t0) * 1e3:9.3f}ms  "
                     f"{e['node']:<22} {e['stage']:<18} {det}")
    return "\n".join(lines)
