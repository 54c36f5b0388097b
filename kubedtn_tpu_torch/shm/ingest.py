"""Daemon-side shared-memory ingest.

Port of kubedtn_tpu/shm/ingest.py (host code, unchanged).

`ShmIngest` owns the consumer half of every attached ring: it scans a
directory for `*.ring` segments (each created by one producer), and on
every `Daemon.drain_ingress` call dequeues committed frames straight
into the drain's output batches — one native call and one columnar
regroup per ring per drain, zero per-frame Python work. The dequeued
columns become the exact (wire, row, lens, [FrameSeg]) shape the gRPC
bulk path produces, so everything downstream — tenant charging,
dispatch, shaping, tracing, delivery — is transport-blind.

Admission is evaluated at the RING HEAD, before any dequeue: the
tenancy layer's per-tick `admit` callable (registry.drain_policy) sees
each ring as a pseudo-wire (`_RingGate`) whose namespace comes from
the segment header and whose queue depth is the ring's pending count.
An over-budget tenant's frames therefore stay parked in its ring —
never copied onto the Python heap — while the policy still records the
typed ThrottleVerdict that feeds admission metrics and SLO
unserved-demand folding. Ring residue the drain could take next tick
folds into `daemon.last_drain_backlog` (entry-denominated, ~256
frames/entry like a bulk FrameSeg) so the adaptive budget and
sleep-shedding react to shm pressure exactly like gRPC pressure.

Crash safety: a dequeue never crosses an uncommitted reservation while
the producer lives (it may be mid-write). Once `producer_dead()`
proves the pid gone, the gap is skipped and counted — committed frames
after the tear are still delivered, torn reservations are never
surfaced. A dead producer's ring is retired (detached, not deleted)
after it fully drains.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from kubedtn_tpu_torch.contracts import guarded_by, requires_lock
from kubedtn_tpu_torch.shm.ring import RING_SUFFIX, ShmRing, ShmRingError

# synthetic wire-id base for throttle verdicts attributed to a ring
# gate (real wire ids are small allocator integers; this range can
# never collide)
_GATE_WIRE_BASE = 0x7E000000


class _RingGate:
    """The pseudo-wire a ring presents to the admission policy:
    pod_key carries the segment's namespace (tenant resolution),
    ingress is the ring itself (len() = parked queue depth for the
    throttle verdict's queued_frames)."""

    __slots__ = ("pod_key", "wire_id", "ingress")

    def __init__(self, pod_key: str, wire_id: int,
                 ring: ShmRing) -> None:
        self.pod_key = pod_key
        self.wire_id = wire_id
        self.ingress = ring


class _RingState:
    __slots__ = ("ring", "gate", "retire_at")

    def __init__(self, ring: ShmRing, gate: _RingGate) -> None:
        self.ring = ring
        self.gate = gate
        self.retire_at = 0.0


@guarded_by("_lock", "_rings", "_retired", "frames_in", "bytes_in",
            "batches", "dequeues", "skipped_uncommitted",
            "throttled_events", "throttled_frames_last",
            "unresolved_frames", "parked_unrealized", "rings_retired",
            "stall_events")
class ShmIngest:
    """The consumer side of every ring in one directory. Attach with
    `daemon.shm = ShmIngest(dir)`; `drain_ingress` then folds ring
    frames into each drain. All of its mutable state is owned by
    `_lock` — the drain runs on the tick thread while metrics
    collectors, the wake watcher and test harnesses read concurrently.
    """

    SCAN_INTERVAL_S = 0.25
    # entry denomination for the backlog signal: one bulk FrameSeg
    # entry holds up to ~256 frames, so ring residue folds in at the
    # same scale instead of frame-counting past the gRPC entries
    ENTRY_FRAMES = 256

    def __init__(self, shm_dir: str,
                 scan_interval_s: float = SCAN_INTERVAL_S) -> None:
        self.shm_dir = shm_dir
        self.scan_interval_s = scan_interval_s
        self._lock = threading.Lock()
        self._rings: dict[str, _RingState] = {}
        self._retired: set[str] = set()
        self._next_scan = 0.0
        self._gate_seq = 0
        self.frames_in = 0
        self.bytes_in = 0
        self.batches = 0       # (wire,row,lens,parts) batches emitted
        self.dequeues = 0      # native dequeue calls
        self.skipped_uncommitted = 0
        self.stall_events = 0  # dequeues ended at a live producer's
        self.throttled_events = 0       # uncommitted reservation
        self.throttled_frames_last = 0  # frames parked by admission,
        self.rings_retired = 0          # last drain (gauge)
        self.unresolved_frames = 0
        self.parked_unrealized = 0
        self._watch_thread: threading.Thread | None = None
        self._watch_stop = threading.Event()

    # -- attachment ----------------------------------------------------

    def attach_ring(self, ring: ShmRing) -> None:
        """Explicit attach (tests, embedders); scan() does this for
        every valid `*.ring` file in shm_dir."""
        with self._lock:
            self._attach_locked(ring)

    @requires_lock("_lock")
    def _attach_locked(self, ring: ShmRing) -> None:
        ns = ring.namespace or "_shm"
        gate = _RingGate(f"{ns}/shm:{ring.name}",
                         _GATE_WIRE_BASE + self._gate_seq, ring)
        self._gate_seq += 1
        self._rings[ring.path] = _RingState(ring, gate)

    def scan(self, force: bool = False) -> None:
        """Pick up newly created segments; drop unlinked ones. Called
        from the drain at scan_interval_s cadence."""
        now = time.monotonic()
        if not force and now < self._next_scan:
            return
        self._next_scan = now + self.scan_interval_s
        try:
            names = os.listdir(self.shm_dir)
        except OSError:
            return
        paths = {os.path.join(self.shm_dir, n) for n in names
                 if n.endswith(RING_SUFFIX)}
        with self._lock:
            for path in list(self._rings):
                if path not in paths:
                    st = self._rings.pop(path)
                    st.ring.close()
            for path in paths:
                if path in self._rings or path in self._retired:
                    continue
                try:
                    self._attach_locked(ShmRing.attach(path))
                except (ShmRingError, OSError):
                    continue  # half-built or foreign file: retry later

    @requires_lock("_lock")
    def _retire_locked(self, st: _RingState) -> None:
        self._rings.pop(st.ring.path, None)
        self._retired.add(st.ring.path)
        self.rings_retired += 1
        st.ring.close()

    def close(self) -> None:
        self.stop_watcher()
        with self._lock:
            for st in self._rings.values():
                st.ring.close()
            self._rings.clear()

    # -- the drain hook ------------------------------------------------

    def drain_into(self, out: list, max_per_wire: int, admit,
                   daemon) -> int:
        """Dequeue each ring (admission first) into `out` as
        (wire, row, lens, [FrameSeg]) batches; returns the
        entry-denominated backlog this drain left behind but could
        take next call. Runs on the tick thread, under no daemon lock
        — ring handoff is the segment's own atomics."""
        self.scan()
        t0 = time.perf_counter()
        with self._lock:
            states = list(self._rings.values())
        backlog = 0
        throttled = 0
        stalled = 0
        drained = 0
        for st in states:
            ring = st.ring
            if ring.pending() == 0:
                if ring.producer_dead():
                    now = time.monotonic()
                    if st.retire_at == 0.0:
                        # linger one scan interval: a producer may die
                        # right after its final commit lands
                        st.retire_at = now + self.scan_interval_s
                    elif now >= st.retire_at:
                        with self._lock:
                            self._retire_locked(st)
                continue
            st.retire_at = 0.0
            budget = max_per_wire
            if admit is not None:
                budget = min(max_per_wire, admit(st.gate))
                if budget <= 0:
                    # over budget: frames stay parked IN the ring —
                    # the policy already recorded the typed verdict.
                    # Excluded from backlog (ticking harder cannot
                    # drain what admission will not release).
                    throttled += ring.pending()
                    with self._lock:
                        self.throttled_events += 1
                    continue
            got = 0
            skip_dead = False
            while got < budget:
                blob, wires, offs, lens, traces, skipped = ring.dequeue(
                    budget - got, skip_uncommitted=skip_dead)
                if skipped:
                    with self._lock:
                        self.skipped_uncommitted += skipped
                if wires is None:
                    # stalled: either empty or an uncommitted gap. Only
                    # cross the gap once the producer is proven dead.
                    if (not skip_dead and ring.pending() > 0
                            and ring.producer_dead()):
                        skip_dead = True
                        continue
                    if not skip_dead and ring.pending() > 0:
                        # a LIVE producer's reservation at the ring
                        # head: committed frames behind it stay parked
                        # until the commit lands — a batch-dequeue
                        # stall, reported to the pause ledger below
                        stalled += 1
                    break
                got += len(wires)
                self._emit(daemon, out, blob, wires, offs, lens, traces)
            drained += got
            residue = ring.pending()
            if residue and got >= budget:
                # budget residue only — same exclusion rules as wires
                backlog += max(1, residue // self.ENTRY_FRAMES)
        with self._lock:
            self.throttled_frames_last = throttled
            self.stall_events += stalled
        if stalled:
            pauses = getattr(getattr(daemon, "dataplane", None),
                             "pauses", None)
            if pauses is not None:
                pauses.record("shm_stall", time.perf_counter() - t0,
                              rows=drained, rings=stalled)
        return backlog

    def _emit(self, daemon, out: list, blob: bytes, wires, offs, lens,
              traces) -> None:
        """Regroup one dequeued span per wire id and append plane
        batches — the shm twin of Daemon._bulk_groups' raw path."""
        from kubedtn_tpu_torch.wire.server import FrameSeg

        n = len(wires)
        nb = len(blob)
        with self._lock:
            self.dequeues += 1
            self.frames_in += n
            self.bytes_in += nb
        if daemon.recorder is not None and traces.any():
            for k in np.nonzero(traces)[0].tolist():
                daemon._record_received(int(traces[k]), int(wires[k]),
                                        False)
        if (wires[0] == wires).all():
            groups = [(int(wires[0]), offs, lens, traces)]
        else:
            order = np.argsort(wires, kind="stable")
            ws = wires[order]
            bounds = np.nonzero(np.diff(ws))[0] + 1
            starts = [0, *bounds.tolist(), n]
            offs_o = offs[order]
            lens_o = lens[order]
            traces_o = traces[order]
            groups = [(int(ws[a]),
                       np.ascontiguousarray(offs_o[a:b]),
                       np.ascontiguousarray(lens_o[a:b]),
                       traces_o[a:b])
                      for a, b in zip(starts, starts[1:])]
        for wid, offs_g, lens_g, traces_g in groups:
            wire = daemon.wires.get_by_id(wid)
            if wire is None:
                daemon.count_bulk_unresolved(len(offs_g))
                with self._lock:
                    self.unresolved_frames += len(offs_g)
                continue
            seg = FrameSeg(blob, offs_g, lens_g)
            if traces_g.any():
                seg.traces = [(int(k), int(traces_g[k]))
                              for k in np.nonzero(traces_g)[0]]
            row = daemon.engine.row_of(wire.pod_key, wire.uid)
            if row is None:
                # link not realized yet: park on the wire's ingress
                # deque — the normal drain retries once it is
                wire.ingress.append(seg)
                with self._lock:
                    self.parked_unrealized += len(offs_g)
                continue
            out.append((wire, row, lens_g, [seg]))
            with self._lock:
                self.batches += 1

    # -- wake watcher ---------------------------------------------------

    def start_watcher(self, daemon, poll_s: float = 0.001) -> None:
        """Edge-triggered runner wake: ring traffic arriving while the
        plane sleeps must start a tick like mark_hot does for gRPC
        ingress. Polls each ring's pending atomics (a few loads per
        ring) and fires daemon.ingress_signal on the empty→non-empty
        transition only, so a throttled ring cannot busy-spin the
        runner."""
        if self._watch_thread is not None:
            return
        self._watch_stop.clear()

        def loop() -> None:
            last: dict[str, int] = {}
            while not self._watch_stop.wait(poll_s):
                with self._lock:
                    states = list(self._rings.values())
                fire = False
                for st in states:
                    p = st.ring.pending()
                    if p and not last.get(st.ring.path):
                        fire = True
                    last[st.ring.path] = p
                if fire:
                    sig = daemon.ingress_signal
                    if sig is not None:
                        sig.set()

        self._watch_thread = threading.Thread(
            target=loop, name="shm-ingest-watch", daemon=True)
        self._watch_thread.start()

    def stop_watcher(self) -> None:
        if self._watch_thread is None:
            return
        self._watch_stop.set()
        self._watch_thread.join(timeout=2.0)
        self._watch_thread = None

    # -- introspection --------------------------------------------------

    def pending_total(self) -> int:
        with self._lock:
            states = list(self._rings.values())
        return sum(st.ring.pending() for st in states)

    def stats(self) -> dict:
        """Point-in-time counters for metrics/tests (one lock hold)."""
        with self._lock:
            states = list(self._rings.values())
            d = {
                "rings": len(states),
                "rings_retired": self.rings_retired,
                "frames_in": self.frames_in,
                "bytes_in": self.bytes_in,
                "batches": self.batches,
                "dequeues": self.dequeues,
                "skipped_uncommitted": self.skipped_uncommitted,
                "stall_events": self.stall_events,
                "throttled_events": self.throttled_events,
                "throttled_frames_last": self.throttled_frames_last,
                "unresolved_frames": self.unresolved_frames,
                "parked_unrealized": self.parked_unrealized,
            }
        d["pending"] = sum(st.ring.pending() for st in states)
        d["full_failures"] = sum(st.ring.full_failures()
                                 for st in states)
        return d
