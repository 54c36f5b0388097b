"""Classic-pcap frame capture for the virtual data plane.

Port of kubedtn_tpu/utils/pcap.py: the same writer, reader and filtered
fan-out, so a capture of the same frames and timestamps is the same file.

The reference's grpc-wire backend holds a live libpcap handle per wire —
capture IS its data path (reference daemon/grpcwire/grpcwire.go:398-409
opens pcap.OpenLive per node-side veth; handler.go:271 writes frames back
through the stored handle). This framework's data plane is device arrays,
so capture becomes an optional observability tap instead: a CaptureManager
attached to the daemon records pod-origin frames ("in", the reference's
DirectionIn capture point) and delivered frames ("out", the reference's
WritePacketData point) into standard pcap files any off-the-shelf tool
(tcpdump -r, wireshark, gopacket) can read.

File format: classic pcap (not pcapng) — magic 0xa1b2c3d4, version 2.4,
LINKTYPE_ETHERNET — microsecond timestamps, host-endian like libpcap's
default writer.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass
from typing import Iterator

PCAP_MAGIC = 0xA1B2C3D4
PCAP_VERSION = (2, 4)
LINKTYPE_ETHERNET = 1
_GLOBAL_HDR = struct.Struct("=IHHiIII")
_REC_HDR = struct.Struct("=IIII")


class PcapWriter:
    """Thread-safe classic-pcap file writer.

    The data plane records from the tick thread while gRPC workers ingest
    frames; one lock per writer keeps records whole. Timestamps are wall
    clock unless the caller passes sim time explicitly.
    """

    def __init__(self, path: str, snaplen: int = 65535,
                 linktype: int = LINKTYPE_ETHERNET) -> None:
        self.path = path
        self.snaplen = snaplen
        self._lock = threading.Lock()
        self._f = open(path, "wb")
        self._f.write(_GLOBAL_HDR.pack(
            PCAP_MAGIC, PCAP_VERSION[0], PCAP_VERSION[1],
            0, 0, snaplen, linktype))
        self.frames_written = 0

    def write(self, frame: bytes, ts: float | None = None) -> None:
        if ts is None:
            ts = time.time()
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        incl = min(len(frame), self.snaplen)
        with self._lock:
            if self._f.closed:
                return  # a racing close() won; drop, don't raise
            self._f.write(_REC_HDR.pack(sec, usec, incl, len(frame)))
            self._f.write(frame[:incl])
            self.frames_written += 1
            # flush per record: a capture must survive SIGKILL/crash with
            # at most the in-flight frame missing — otherwise a low-traffic
            # capture can die as an empty file inside the io buffer
            self._f.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


@dataclass(frozen=True)
class CapturedFrame:
    ts: float
    orig_len: int
    frame: bytes


def read_pcap(path: str) -> Iterator[CapturedFrame]:
    """Parse a classic pcap file back (verification / tooling)."""
    with open(path, "rb") as f:
        hdr = f.read(_GLOBAL_HDR.size)
        if len(hdr) < _GLOBAL_HDR.size:
            raise ValueError(f"{path}: truncated pcap global header")
        magic = _GLOBAL_HDR.unpack(hdr)[0]
        if magic != PCAP_MAGIC:
            raise ValueError(f"{path}: bad pcap magic {magic:#x}")
        while True:
            rec = f.read(_REC_HDR.size)
            if not rec:
                return
            if len(rec) < _REC_HDR.size:
                raise ValueError(f"{path}: truncated record header")
            sec, usec, incl, orig = _REC_HDR.unpack(rec)
            data = f.read(incl)
            if len(data) < incl:
                raise ValueError(f"{path}: truncated frame body")
            yield CapturedFrame(ts=sec + usec / 1e6, orig_len=orig,
                                frame=data)


@dataclass
class _Tap:
    writer: PcapWriter
    pod_key: str | None  # None = any
    uid: int | None      # None = any
    direction: str | None  # "in" | "out" | None = both


class CaptureManager:
    """Filtered fan-out of data-plane frames to pcap writers.

    Attach points in the daemon/runtime (kept nil-cost when no manager is
    installed): pod-origin ingestion records "in"; delivery to a pod-side
    wire records "out". Frames a tap doesn't match cost one predicate
    check each.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()  # guards tap-set mutation only
        # copy-on-write: record() reads this tuple lock-free on the
        # per-frame hot path; open/close_all swap in a new tuple
        self._taps: tuple[_Tap, ...] = ()

    def open(self, path: str, pod_key: str | None = None,
             uid: int | None = None,
             direction: str | None = None) -> PcapWriter:
        """Create a writer and attach it; returns the writer (close it via
        close_all or writer.close)."""
        if direction not in (None, "in", "out"):
            raise ValueError(f"direction must be in/out/None: {direction!r}")
        w = PcapWriter(path)
        with self._lock:
            self._taps = self._taps + (_Tap(w, pod_key, uid, direction),)
        return w

    def record(self, pod_key: str, uid: int, frame: bytes,
               direction: str, ts: float | None = None) -> None:
        for t in self._taps:
            if t.pod_key is not None and t.pod_key != pod_key:
                continue
            if t.uid is not None and t.uid != uid:
                continue
            if t.direction is not None and t.direction != direction:
                continue
            t.writer.write(frame, ts)

    def close_all(self) -> None:
        with self._lock:
            taps, self._taps = self._taps, ()
        for t in taps:
            t.writer.close()
