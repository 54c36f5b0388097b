"""Producer-side ring sender.

Port of kubedtn_tpu/shm/sender.py (host code, unchanged).

`ShmSender` is the shm twin of the runtime's `_PeerSender` (gRPC
egress): same outage-buffer discipline, different transport. A send
never drops a frame — frames the ring cannot take (full: the consumer
is behind or the tenant is being throttled at the ring head) go to a
bounded in-process buffer that later sends and `flush()` drain first
(FIFO preserved); when the buffer itself is full, `send()` BLOCKS in
small sleeps — producer-side backpressure, with the blocked time
accounted. Exact accounting invariant, tested: every frame handed to
send() is eventually pushed exactly once, in order, or still sits in
`buffered()`.

Trace sampling: with sample_period=N every Nth frame is stamped with a
splitmix64 trace id (the flight recorder's id scheme) carried in the
slot layout — the daemon's ingest attaches its `received` event and
the data plane carries the SAME id through to delivery, so `kdt trace`
spans shm ingest exactly like gRPC ingest. Minted ids are kept (ring
buffer of the last 1024) for harnesses to assert end-to-end traces.
"""

from __future__ import annotations

import os
import time
from collections import deque

from kubedtn_tpu_torch.shm.ring import (DEFAULT_SLOT_SIZE, DEFAULT_SLOTS,
                                  ShmRing)


class ShmSender:
    """One producer process's handle: creates (or adopts) the ring
    file and owns its tail. Single-threaded like _PeerSender's queue
    head — one sender instance per ring, per process."""

    MAX_BUFFERED = 65536
    _BLOCK_SLEEP_S = 0.0005

    def __init__(self, path: str, slots: int = DEFAULT_SLOTS,
                 slot_size: int = DEFAULT_SLOT_SIZE,
                 namespace: str = "",
                 max_buffered: int = MAX_BUFFERED,
                 sample_period: int = 0,
                 trace_seed: int | None = None) -> None:
        self.ring = ShmRing.create(path, slots=slots,
                                   slot_size=slot_size,
                                   namespace=namespace)
        self.max_buffered = max_buffered
        self.sample_period = sample_period
        self._seed = (trace_seed if trace_seed is not None
                      else (os.getpid() << 20) ^ 0x5BD1)
        self._n = 0          # frames accepted (sampling counter)
        self.pushed = 0      # frames committed into the ring
        self.blocked_s = 0.0
        self.buffered_peak = 0
        self._buf: deque = deque()  # (wire_id, frame, trace_id)
        self.minted = deque(maxlen=1024)  # recent sampled trace ids

    # -- internals -----------------------------------------------------

    def _tid_for(self, i: int) -> int:
        if self.sample_period <= 0 or i % self.sample_period:
            return 0
        # here, not at import: telemetry brings torch, which a producer
        # that samples nothing never needs
        from kubedtn_tpu_torch.telemetry import _mix64

        tid = _mix64(self._seed + i) or 1
        self.minted.append(tid)
        return tid

    def _pump(self) -> bool:
        """Push buffered frames (FIFO, grouped per contiguous wire
        run). True when the buffer fully drained."""
        while self._buf:
            wid = self._buf[0][0]
            run_frames: list[bytes] = []
            run_tids: list[int] = []
            for w, f, t in self._buf:
                if w != wid:
                    break
                run_frames.append(f)
                run_tids.append(t)
            pushed = self.ring.push_batch(run_frames, wid, run_tids)
            self.pushed += pushed
            for _ in range(pushed):
                self._buf.popleft()
            if pushed < len(run_frames):
                return False  # ring full again: stop, keep FIFO
        return True

    # -- API -----------------------------------------------------------

    def send(self, wire_id: int, frames: list[bytes],
             block_timeout_s: float | None = None) -> None:
        """Queue frames for the ring, never dropping: ring-full parks
        them in the outage buffer; a full buffer blocks (bounded by
        block_timeout_s when given — expiry raises TimeoutError with
        every frame still accounted in buffered())."""
        tids = [self._tid_for(self._n + k) for k in range(len(frames))]
        self._n += len(frames)
        if not self._buf:
            pushed = self.ring.push_batch(frames, wire_id, tids)
            self.pushed += pushed
            if pushed == len(frames):
                return
            frames = frames[pushed:]
            tids = tids[pushed:]
        deadline = (time.monotonic() + block_timeout_s
                    if block_timeout_s is not None else None)
        for f, t in zip(frames, tids):
            while len(self._buf) >= self.max_buffered:
                t0 = time.monotonic()
                if self._pump():
                    break
                if deadline is not None and t0 >= deadline:
                    self.blocked_s += time.monotonic() - t0
                    raise TimeoutError(
                        f"outage buffer full ({len(self._buf)} frames) "
                        f"and the ring did not drain")
                time.sleep(self._BLOCK_SLEEP_S)
                self.blocked_s += time.monotonic() - t0
            self._buf.append((wire_id, f, t))
        self._pump()
        self.buffered_peak = max(self.buffered_peak, len(self._buf))

    def flush(self, timeout_s: float | None = None) -> bool:
        """Drain the outage buffer into the ring; True when empty.
        The ring itself still holds frames until the daemon dequeues —
        use ring.pending() to wait on full end-to-end drain."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while not self._pump():
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(self._BLOCK_SLEEP_S)
        return True

    def buffered(self) -> int:
        return len(self._buf)

    def stats(self) -> dict:
        return {
            "accepted": self._n,
            "pushed": self.pushed,
            "buffered": len(self._buf),
            "buffered_peak": self.buffered_peak,
            "blocked_s": self.blocked_s,
            "ring_pending": self.ring.pending(),
            "ring_full_failures": self.ring.full_failures(),
        }

    def close(self, unlink: bool = False) -> None:
        path = self.ring.path
        self.ring.close()
        if unlink:
            try:
                os.remove(path)
            except OSError:
                pass
