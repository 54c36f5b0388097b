"""Memory-mapped SPSC ingest ring — the Python handle over one
`kdt_shm_*` segment (native/kubedtn_native.cc section 5).

Port of kubedtn_tpu/shm/ring.py over the port's own build of the native
library (kubedtn_tpu_torch.native): the segment layout is the library's,
so a ring created by either package is read by the other. `attach`
refuses a still-empty file with ShmRingError (the JAX package's raises
mmap's ValueError there, which its ingest scan does not catch), and its
introspection reads (`pending`, `committed`, ...) read a closed ring as
empty: the ingest's watcher and the metrics scrape read rings on their
own threads while the drain retires them.

One ring file per producer process: the producer creates it (`create`)
and owns the tail/commit side; the daemon attaches (`attach`) and owns
the head side. All cross-process state lives in the mapped segment's
three atomics (tail, head, full_failures) plus the per-slot commit
words — this class only wraps the native calls with mmap lifetime and
numpy marshalling, so both sides of the protocol stay in one audited C
implementation.

Dequeue hands back COLUMNS (blob + wire/off/len/trace arrays), the
shape `wire.server.FrameSeg` consumes directly: one native call and
one columnar regroup per drain, zero per-frame Python work on the
consumer side. The blob is a real `bytes` object (the `kdt_ext`
slice_frames materializer requires it), which costs one extra memcpy
of payload per dequeue on top of the native slot→scratch copy —
documented, measured, and still ~2 orders of magnitude below the
per-frame gRPC path's cost.
"""

from __future__ import annotations

import ctypes
import mmap
import os

import numpy as np

from kubedtn_tpu_torch import native

RING_SUFFIX = ".ring"
DEFAULT_SLOTS = 8192
DEFAULT_SLOT_SIZE = 2048
SLOT_HDR = 16  # u32 frame_len | u32 wire_id | u64 trace_id

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)


class ShmRingError(RuntimeError):
    """Segment invalid (bad magic/version/geometry) or native missing."""


def _lib():
    try:
        return native._load()
    except native.NativeUnavailable as e:
        raise ShmRingError(f"shm ring needs the native library: {e}") from e


class ShmRing:
    """Handle over one mapped ring segment. SPSC: at most one process
    pushes, at most one dequeues; a single process may do both (tests).

    `len(ring)` is the reserved-and-unconsumed entry count (committed
    or not) — the admission gate reads it as the parked-queue depth,
    matching `len(wire.ingress)` frame semantics on the gRPC path."""

    def __init__(self, path: str, mm: mmap.mmap, size: int) -> None:
        self.path = path
        self.name = os.path.basename(path)
        self._mm = mm
        self._size = size
        self._buf = (ctypes.c_uint8 * size).from_buffer(mm)
        self._l = _lib()
        self.slots = int(self._l.kdt_shm_slots(self._buf))
        self.slot_size = int(self._l.kdt_shm_slot_size(self._buf))
        self.payload_cap = self.slot_size - SLOT_HDR
        ns = ctypes.create_string_buffer(64)
        self._l.kdt_shm_ns(self._buf, ns, 64)
        self.namespace = ns.value.decode("utf-8", "replace")
        # consumer-side dequeue marshalling state, reused across drains
        self._o_wire = None
        self._o_off = None
        self._o_len = None
        self._o_trace = None
        self._o_skip = ctypes.c_uint64(0)
        self._scratch = None
        self._scratch_buf = None

    # -- lifecycle -----------------------------------------------------

    @classmethod
    def create(cls, path: str, slots: int = DEFAULT_SLOTS,
               slot_size: int = DEFAULT_SLOT_SIZE, namespace: str = "",
               pid: int | None = None) -> "ShmRing":
        """Producer side: size the file, map it, initialize the header.
        The magic is stored last (release), so a concurrently scanning
        daemon never attaches a half-built segment."""
        lib = _lib()
        need = int(lib.kdt_shm_required(slots, slot_size))
        if need <= 0:
            raise ShmRingError(
                f"bad ring geometry slots={slots} slot_size={slot_size}")
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, need)
            mm = mmap.mmap(fd, need)
        finally:
            os.close(fd)
        buf = (ctypes.c_uint8 * need).from_buffer(mm)
        ok = lib.kdt_shm_init(buf, need, slots, slot_size,
                              pid if pid is not None else os.getpid(),
                              namespace.encode("utf-8"))
        del buf
        if not ok:
            mm.close()
            raise ShmRingError(f"ring init failed for {path}")
        return cls(path, mm, need)

    @classmethod
    def attach(cls, path: str) -> "ShmRing":
        """Consumer side: map an existing segment and validate it."""
        lib = _lib()
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            if size == 0:
                # a producer between creating the file and sizing it:
                # not a segment yet (mmap refuses an empty file)
                raise ShmRingError(f"empty ring file: {path}")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        buf = (ctypes.c_uint8 * size).from_buffer(mm)
        ok = lib.kdt_shm_check(buf, size)
        del buf
        if not ok:
            mm.close()
            raise ShmRingError(f"not a valid ring segment: {path}")
        return cls(path, mm, size)

    def close(self) -> None:
        self._o_wire = self._o_off = self._o_len = self._o_trace = None
        self._scratch = self._scratch_buf = None
        self._buf = None
        try:
            self._mm.close()
        except BufferError:
            pass  # a live ctypes export pins the map until gc

    # -- introspection -------------------------------------------------

    def _read(self, fn) -> int:
        """One introspection read of the segment, 0 once it is closed.
        Other threads read a ring the drain may retire (close) meanwhile:
        the local reference pins the map for the read (close() then
        leaves it to gc), and a closed ring reads as empty instead of
        handing the native side a NULL segment. The JAX package reads
        `self._buf` unguarded and faults there (pinned in
        tests/test_torch_shm.py)."""
        buf = self._buf
        return 0 if buf is None else int(fn(buf))

    def __len__(self) -> int:
        return self.pending()

    def pending(self) -> int:
        """Reserved-and-unconsumed entries (committed or not)."""
        return self._read(self._l.kdt_shm_pending)

    def committed(self) -> int:
        """Committed-and-unconsumed frames — O(pending) commit-word
        walk, for accounting/audits, not the hot path."""
        return self._read(self._l.kdt_shm_committed)

    def full_failures(self) -> int:
        return self._read(self._l.kdt_shm_full_failures)

    def producer_pid(self) -> int:
        return self._read(self._l.kdt_shm_pid)

    def producer_dead(self) -> bool:
        """True only when the recorded producer pid provably no longer
        exists — the precondition for skipping uncommitted gaps."""
        pid = self.producer_pid()
        if pid <= 0 or pid == os.getpid():
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:
            return False
        return False

    # -- producer side -------------------------------------------------

    def push(self, frame: bytes, wire_id: int, trace_id: int = 0) -> int:
        """1 pushed / 0 ring-full (counted) / -1 frame too big."""
        n = len(frame)
        fb = (ctypes.c_uint8 * n).from_buffer_copy(frame) if n else None
        return int(self._l.kdt_shm_push(self._buf, fb, n, wire_id,
                                        trace_id))

    def push_batch(self, frames: list[bytes], wire_id: int,
                   trace_ids=None) -> int:
        """Columnar batch push for ONE wire; returns frames pushed
        (stops at ring-full — the caller's outage buffer keeps the
        rest). Frames larger than the slot payload raise."""
        if not frames:
            return 0
        lens = np.fromiter((len(f) for f in frames), np.uint64,
                           len(frames))
        if int(lens.max()) > self.payload_cap:
            raise ShmRingError(
                f"frame exceeds slot payload ({self.payload_cap}B)")
        offs = np.zeros(len(frames), np.uint64)
        np.cumsum(lens[:-1], out=offs[1:])
        blob = b"".join(frames)
        wires = np.full(len(frames), wire_id, np.uint32)
        if trace_ids is None:
            traces = np.zeros(len(frames), np.uint64)
        else:
            traces = np.ascontiguousarray(trace_ids, np.uint64)
        bb = (ctypes.c_uint8 * len(blob)).from_buffer_copy(blob)
        return int(self._l.kdt_shm_push_batch(
            self._buf, bb,
            offs.ctypes.data_as(_u64p), lens.ctypes.data_as(_u64p),
            wires.ctypes.data_as(_u32p), traces.ctypes.data_as(_u64p),
            len(frames)))

    def push_torn(self, n: int = 1) -> bool:
        """Test hook: reserve n slots and never commit — the frozen
        image of a producer killed between reserve and publish."""
        return bool(self._l.kdt_shm_push_torn(self._buf, n))

    # -- consumer side -------------------------------------------------

    _MAX_DEQ = 16384
    _SCRATCH = 4 << 20

    def _ensure_out(self) -> None:
        if self._o_wire is None:
            self._o_wire = np.empty(self._MAX_DEQ, np.uint32)
            self._o_off = np.empty(self._MAX_DEQ, np.uint64)
            self._o_len = np.empty(self._MAX_DEQ, np.uint64)
            self._o_trace = np.empty(self._MAX_DEQ, np.uint64)
            self._scratch = bytearray(self._SCRATCH)
            self._scratch_buf = (ctypes.c_uint8 *
                                 self._SCRATCH).from_buffer(self._scratch)

    def dequeue(self, max_frames: int, skip_uncommitted: bool = False):
        """Batch-dequeue committed frames: ONE native call copying the
        committed span into a scratch blob + flat columns. Returns
        (blob bytes, wires u32, offs u64, lens u64, traces u64,
        skipped) — arrays are private copies, the blob is a real bytes
        object (FrameSeg/kdt_ext contract). Stops at the first
        uncommitted reservation unless skip_uncommitted, which callers
        may only pass after producer_dead() proved the producer gone."""
        self._ensure_out()
        n = int(self._l.kdt_shm_dequeue(
            self._buf, self._scratch_buf, self._SCRATCH,
            self._o_wire.ctypes.data_as(_u32p),
            self._o_off.ctypes.data_as(_u64p),
            self._o_len.ctypes.data_as(_u64p),
            self._o_trace.ctypes.data_as(_u64p),
            min(max_frames, self._MAX_DEQ),
            1 if skip_uncommitted else 0,
            ctypes.byref(self._o_skip)))
        skipped = int(self._o_skip.value)
        if n == 0:
            return b"", None, None, None, None, skipped
        used = int(self._o_off[n - 1] + self._o_len[n - 1])
        blob = bytes(memoryview(self._scratch)[:used])
        return (blob,
                self._o_wire[:n].copy(),
                self._o_off[:n].copy(),
                self._o_len[:n].copy(),
                self._o_trace[:n].copy(),
                skipped)
