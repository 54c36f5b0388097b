"""ctypes bindings for the native runtime library (native/kubedtn_native.cc).

The port's own bindings of the C++ library the JAX package also uses. The
live plane needs three of its capabilities:

- `TimingWheel`: the hashed hierarchical timing wheel that holds the
  delay line (the role the kernel's qdisc watchdog plays for netem);
- `FlowTable`: the eBPF TCP/IP-bypass state machine (reference
  bpf/lib/sockops.c, redir.c, redir_disable.c) fused with the per-protocol
  frame classifier, one native call per tick;
- `FrameRing` and the PacketBatch / frame decoders (reference
  daemon/grpcwire/grpcwire.go:398-613).

It also declares the shared-memory ring's `kdt_shm_*` entry points
(native/kubedtn_native.cc section 5), which kubedtn_tpu_torch.shm.ring
wraps: the segment format is the library's, so a ring one package
writes the other reads.

The library is built at first use with g++ (the flags of
native/Makefile) into `kubedtn_tpu_torch/_build/`, under a name that
carries a hash of the source and the flags, so an edited source is never
served a stale build. The build never writes into `native/` or the JAX
package. A failed build raises `NativeUnavailable`; the live plane has no
fallback without the library.

`kdt_ext()` builds the CPython extension native/kdt_ext.c the same way,
with cc against the running interpreter's headers, into `_build/` under
an ABI-tagged name (sysconfig's EXT_SUFFIX), and loads it from that path
with importlib. Its `slice_frames` materializes a segment's frames in one
C loop (wire/server.FrameSeg.materialize). As in the JAX package, the
extension is optional where the Python headers do not resolve: the
pure-Python path stays, and the reason is logged once. Where the headers
resolve and the build fails, it raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = (Path(__file__).resolve().parent.parent / "native"
          / "kubedtn_native.cc")
EXT_SOURCE = SOURCE.with_name("kdt_ext.c")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
EXT_FLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib = None
# the CPython extension: (tried, module or None, reason it is absent)
_ext_state: tuple = (False, None, None)

FRAME_TYPES = {
    0: "UNKNOWN", 1: "IPv4", 2: "IPv6", 3: "ARP", 4: "VLAN", 5: "LLC",
    6: "ISIS", 7: "ICMP", 8: "TCP", 9: "BGP", 10: "UDP", 11: "ICMPv6",
}

PROXY_INIT = 0
PROXY_ENABLED = 1
PROXY_DISABLED = 2


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def _declare(lib) -> None:
    c = ctypes
    u8p, u64p = c.POINTER(c.c_uint8), c.POINTER(c.c_uint64)
    sigs = {
        "kdt_decode_frame": (c.c_int64, [u8p, c.c_uint64, c.c_char_p,
                                         c.c_uint64]),
        "kdt_classify_frame": (c.c_int32, [u8p, c.c_uint64]),
        "kdt_classify_batch": (None, [u8p, u64p, u64p, c.c_int64,
                                      c.POINTER(c.c_int32)]),
        "kdt_classify_batch_ptrs": (None, [c.POINTER(c.c_char_p), u64p,
                                           c.c_int64,
                                           c.POINTER(c.c_int32)]),
        "kdt_parse_packet_batch": (c.c_int64, [u8p, c.c_uint64,
                                               c.POINTER(c.c_int64),
                                               u64p, u64p, c.c_int64]),
        "kdt_parse_packet_batch_t": (c.c_int64, [u8p, c.c_uint64,
                                                 c.POINTER(c.c_int64),
                                                 u64p, u64p, u64p,
                                                 c.c_int64]),
        "kdt_ft_decide_batch_ptrs": (c.c_int64, [c.c_void_p,
                                                 c.POINTER(c.c_char_p),
                                                 u64p, c.c_int64, u8p,
                                                 u8p, u8p]),
        "kdt_ft_decide_classify_batch_ptrs": (
            c.c_int64, [c.c_void_p, c.POINTER(c.c_char_p), u64p,
                        c.c_int64, u8p, u8p, u8p, u8p,
                        c.POINTER(c.c_int32)]),
        "kdt_ft_new": (c.c_void_p, [c.c_uint64]),
        "kdt_ft_free": (None, [c.c_void_p]),
        "kdt_ft_active_established": (None, [c.c_void_p, c.c_uint32,
                                             c.c_uint16, c.c_uint32,
                                             c.c_uint16]),
        "kdt_ft_passive_established": (c.c_int32, [c.c_void_p, c.c_uint32,
                                                   c.c_uint16, c.c_uint32,
                                                   c.c_uint16]),
        "kdt_ft_msg_redirect": (c.c_int32, [c.c_void_p, c.c_uint32,
                                            c.c_uint16, c.c_uint32,
                                            c.c_uint16]),
        "kdt_ft_shaped_egress": (None, [c.c_void_p, c.c_uint32, c.c_uint16,
                                        c.c_uint32, c.c_uint16]),
        "kdt_ft_close": (None, [c.c_void_p, c.c_uint32, c.c_uint16,
                                c.c_uint32, c.c_uint16]),
        "kdt_ft_flag": (c.c_int32, [c.c_void_p, c.c_uint32, c.c_uint16,
                                    c.c_uint32, c.c_uint16]),
        "kdt_ft_size": (c.c_uint64, [c.c_void_p]),
        "kdt_ft_bypassed": (c.c_uint64, [c.c_void_p]),
        "kdt_ft_passed": (c.c_uint64, [c.c_void_p]),
        "kdt_rb_new": (c.c_void_p, [c.c_uint64]),
        "kdt_rb_free": (None, [c.c_void_p]),
        "kdt_rb_push": (c.c_int32, [c.c_void_p, u8p, c.c_uint32]),
        "kdt_rb_pop": (c.c_int64, [c.c_void_p, u8p, c.c_uint64]),
        "kdt_rb_count": (c.c_uint64, [c.c_void_p]),
        "kdt_rb_dropped": (c.c_uint64, [c.c_void_p]),
        "kdt_shm_required": (c.c_int64, [c.c_uint64, c.c_uint32]),
        "kdt_shm_init": (c.c_int32, [u8p, c.c_uint64, c.c_uint64,
                                     c.c_uint32, c.c_uint64, c.c_char_p]),
        "kdt_shm_check": (c.c_int32, [u8p, c.c_uint64]),
        "kdt_shm_slots": (c.c_uint64, [u8p]),
        "kdt_shm_slot_size": (c.c_uint32, [u8p]),
        "kdt_shm_pid": (c.c_uint64, [u8p]),
        "kdt_shm_set_pid": (None, [u8p, c.c_uint64]),
        "kdt_shm_ns": (c.c_int32, [u8p, c.c_char_p, c.c_int32]),
        "kdt_shm_pending": (c.c_uint64, [u8p]),
        "kdt_shm_full_failures": (c.c_uint64, [u8p]),
        "kdt_shm_committed": (c.c_uint64, [u8p]),
        "kdt_shm_push": (c.c_int32, [u8p, u8p, c.c_uint32, c.c_uint32,
                                     c.c_uint64]),
        "kdt_shm_push_batch": (c.c_int64, [u8p, u8p, u64p, u64p,
                                           c.POINTER(c.c_uint32), u64p,
                                           c.c_int64]),
        "kdt_shm_push_torn": (c.c_int32, [u8p, c.c_uint32]),
        "kdt_shm_dequeue": (c.c_int64, [u8p, u8p, c.c_uint64,
                                        c.POINTER(c.c_uint32), u64p, u64p,
                                        u64p, c.c_int64, c.c_int32, u64p]),
        "kdt_tw_new": (c.c_void_p, [c.c_uint64, c.c_uint32, c.c_uint32]),
        "kdt_tw_free": (None, [c.c_void_p]),
        "kdt_tw_schedule": (None, [c.c_void_p, c.c_uint64, c.c_uint64]),
        "kdt_tw_schedule_batch": (None, [c.c_void_p, u64p, u64p,
                                         c.c_int64]),
        "kdt_tw_advance": (c.c_int64, [c.c_void_p, c.c_uint64, u64p,
                                       c.c_int64]),
        "kdt_tw_size": (c.c_uint64, [c.c_void_p]),
        "kdt_tw_next_due_us": (c.c_uint64, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    if not SOURCE.exists():
        raise NativeUnavailable(f"native source {SOURCE} is missing")
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libkubedtn_native-{digest.hexdigest()[:16]}.so"


def _compile(cmd: list, target: Path, what: str) -> None:
    """Run one compiler command that writes `target` through a temp
    file and an atomic rename (a concurrent loader never sees half)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([*cmd, "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=300)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"{what} build failed:\n{e.stderr}") from e
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"{what} build failed: {e}") from e
    os.replace(tmp, target)


def _build(target: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeUnavailable("g++ not found: the native library "
                                "cannot be built")
    _compile([cxx, *CXX_FLAGS, str(SOURCE)], target, "native")


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        try:
            lib = ctypes.CDLL(str(target))
            _declare(lib)
        except (OSError, AttributeError) as e:
            raise NativeUnavailable(f"native load failed: {e}") from e
        _lib = lib
        return lib


def python_include() -> tuple[str, bool]:
    """The running interpreter's header directory, and whether it holds
    Python.h (the extension's build needs it)."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    return inc, os.path.exists(os.path.join(inc, "Python.h"))


def kdt_ext_path() -> Path:
    """Where the extension's build for this source, these flags and this
    interpreter lives (ABI-tagged: another interpreter's build does not
    import, it is rebuilt)."""
    import sysconfig

    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    inc, _ = python_include()
    digest = hashlib.sha256(EXT_SOURCE.read_bytes()
                            + " ".join(EXT_FLAGS).encode()
                            + inc.encode() + suffix.encode())
    return BUILD_DIR / f"kdt_ext-{digest.hexdigest()[:16]}{suffix}"


def kdt_ext():
    """The loaded kdt_ext module, built at first use; None where the
    Python headers do not resolve (the reason is logged once and kept in
    `kdt_ext_reason()`). Raises NativeUnavailable when the headers
    resolve and the build or the import fails."""
    global _ext_state
    tried, mod, _why = _ext_state
    if tried:
        return mod
    with _lock:
        if _ext_state[0]:
            return _ext_state[1]
        inc, ok = python_include()
        if not ok:
            why = f"Python.h not found under {inc}"
            from kubedtn_tpu_torch.utils.logging import fields, get_logger

            get_logger("native").warning(
                "kdt_ext not built; frames materialize in Python %s",
                fields(reason=why))
            _ext_state = (True, None, why)
            return None
        target = kdt_ext_path()
        if not target.exists():
            cc = (os.environ.get("CC") or shutil.which("cc")
                  or shutil.which("gcc"))
            if not cc:
                raise NativeUnavailable("no C compiler found: kdt_ext "
                                        "cannot be built")
            _compile([cc, *EXT_FLAGS, f"-I{inc}", str(EXT_SOURCE)],
                     target, "kdt_ext")
        import importlib.util

        try:
            spec = importlib.util.spec_from_file_location("kdt_ext",
                                                          target)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as e:
            raise NativeUnavailable(f"kdt_ext load failed: {e}") from e
        _ext_state = (True, mod, None)
        return mod


def kdt_ext_reason() -> str | None:
    """Why kdt_ext is not loaded (None when it is, or before the first
    kdt_ext() call)."""
    return _ext_state[2]


def have_native() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _buf(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def decode_frame(frame: bytes) -> str:
    """Human-readable frame classification, format-parity with the
    reference's DecodeFrame (grpcwire.go:465-498)."""
    lib = _load()
    out = ctypes.create_string_buffer(4096)
    lib.kdt_decode_frame(_buf(frame), len(frame), out, len(out))
    return out.value.decode()


def classify_frame(frame: bytes) -> str:
    """Innermost protocol name of the frame (e.g. "BGP", "ARP", "ISIS")."""
    lib = _load()
    return FRAME_TYPES[lib.kdt_classify_frame(_buf(frame), len(frame))]


def frame_ptrs_u64(frames: list[bytes]):
    """uint64[n] array of the frames' buffer addresses for the
    pointer-array native calls. A c_char_p array's buffer IS a uint64
    pointer array; the returned frombuffer view keeps that array — and
    through it the frames — alive, but the CALLER must keep the frames
    themselves referenced until the native call returns. The lifetime
    contract lives HERE, once: decide_classify_batch and the data
    plane's mixed bytes/segment pointer builder both use it."""
    import numpy as np

    arr = (ctypes.c_char_p * len(frames))(*frames)
    return np.frombuffer(arr, np.uint64)


def _frame_arrays(frames: list[bytes]):
    """(blob, offs u64[n], lens u64[n]) for a blob-form batch call (the
    offline decoder paths; the data-plane hot paths use the pointer-array
    forms and never concatenate)."""
    import numpy as np

    n = len(frames)
    blob = b"".join(frames)
    lens = np.fromiter((len(f) for f in frames), np.uint64, count=n)
    offs = np.zeros(n, np.uint64)
    np.cumsum(lens[:-1], out=offs[1:])
    return blob, offs, lens


def classify_batch(frames: list[bytes]) -> list[str]:
    """One native call for a whole ingress drain."""
    import numpy as np

    lib = _load()
    n = len(frames)
    if n == 0:
        return []
    blob, offs, lens = _frame_arrays(frames)
    out = np.zeros(n, np.int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kdt_classify_batch(
        _buf(blob), offs.ctypes.data_as(u64p), lens.ctypes.data_as(u64p),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return [FRAME_TYPES[v] for v in out.tolist()]


def parse_packet_batch(blob: bytes):
    """Decode one serialized PacketBatch into flat numpy arrays
    (ids[int64], frame_offsets[uint64], frame_lens[uint64]) in ONE
    native call — the ingestion hot path's replacement for a protobuf
    runtime that would build a Python message object per frame. Offsets
    index into `blob`; the caller materializes each frame as one bytes
    slice. Raises ValueError on malformed input (callers fall back to
    the protobuf runtime)."""
    import numpy as np

    lib = _load()
    nb = len(blob)
    # every packet costs >= 2 bytes of framing (tag + length)
    n_max = nb // 2 + 1
    ids = np.empty(n_max, np.int64)
    offs = np.empty(n_max, np.uint64)
    lens = np.empty(n_max, np.uint64)
    c = ctypes
    u64p = c.POINTER(c.c_uint64)
    # zero-copy: c_char_p borrows the bytes object's buffer (the parser
    # only reads, and the returned offsets index the Python-side blob)
    n = lib.kdt_parse_packet_batch(
        c.cast(c.c_char_p(blob), c.POINTER(c.c_uint8)), nb,
        ids.ctypes.data_as(c.POINTER(c.c_int64)),
        offs.ctypes.data_as(u64p), lens.ctypes.data_as(u64p), n_max)
    if n < 0:
        raise ValueError("malformed PacketBatch")
    return ids[:n], offs[:n], lens[:n]


def parse_packet_batch_traced(blob: bytes):
    """parse_packet_batch that also decodes each packet's OPTIONAL
    `trace_id` (Packet field 3, the flight recorder's cross-node
    correlation id) in the same single native walk — the zero-copy
    ingestion path stays zero-copy while sampled frames keep their
    trace. Returns (ids, frame_offsets, frame_lens, trace_ids[uint64],
    0 = untraced); raises ValueError on malformed input."""
    import numpy as np

    lib = _load()
    nb = len(blob)
    n_max = nb // 2 + 1
    ids = np.empty(n_max, np.int64)
    offs = np.empty(n_max, np.uint64)
    lens = np.empty(n_max, np.uint64)
    traces = np.empty(n_max, np.uint64)
    c = ctypes
    u64p = c.POINTER(c.c_uint64)
    n = lib.kdt_parse_packet_batch_t(
        c.cast(c.c_char_p(blob), c.POINTER(c.c_uint8)), nb,
        ids.ctypes.data_as(c.POINTER(c.c_int64)),
        offs.ctypes.data_as(u64p), lens.ctypes.data_as(u64p),
        traces.ctypes.data_as(u64p), n_max)
    if n < 0:
        raise ValueError("malformed PacketBatch")
    return ids[:n], offs[:n], lens[:n], traces[:n]


def classify_counts(frames: list[bytes], lens=None) -> dict[str, int]:
    """Per-protocol counts for a whole drain with NO per-frame Python
    beyond a pointer-array build: one native call + one bincount (the
    hot-path form of classify_batch — the data plane only needs the
    counters, and the pointer form skips the blob concatenation)."""
    import numpy as np

    lib = _load()
    n = len(frames)
    if n == 0:
        return {}
    ptrs = (ctypes.c_char_p * n)(*frames)
    if lens is None:
        lens_a = np.fromiter((len(f) for f in frames), np.uint64, count=n)
    else:
        lens_a = np.ascontiguousarray(lens, np.uint64)
    out = np.zeros(n, np.int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.kdt_classify_batch_ptrs(
        ptrs, lens_a.ctypes.data_as(u64p), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    counts = np.bincount(out, minlength=len(FRAME_TYPES))
    return {FRAME_TYPES[i]: int(c)
            for i, c in enumerate(counts.tolist()) if c}


def _ip(v) -> int:
    """Accept dotted-quad strings or raw uint32."""
    if isinstance(v, int):
        return v
    parts = [int(x) for x in v.split(".")]
    return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]


class FlowTable:
    """The eBPF bypass state machine (see module docstring)."""

    def __init__(self, capacity: int = 65535) -> None:
        self._lib = _load()
        self._h = self._lib.kdt_ft_new(capacity)

    def close(self) -> None:
        if self._h:
            self._lib.kdt_ft_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def active_established(self, lip, lport, rip, rport) -> None:
        self._lib.kdt_ft_active_established(self._h, _ip(lip), lport,
                                            _ip(rip), rport)

    def passive_established(self, lip, lport, rip, rport) -> bool:
        return bool(self._lib.kdt_ft_passive_established(
            self._h, _ip(lip), lport, _ip(rip), rport))

    def msg_redirect(self, lip, lport, rip, rport) -> bool:
        """True ⇒ this message bypasses the shaping data plane."""
        return bool(self._lib.kdt_ft_msg_redirect(
            self._h, _ip(lip), lport, _ip(rip), rport))

    def shaped_egress(self, sip, sport, dip, dport) -> None:
        self._lib.kdt_ft_shaped_egress(self._h, _ip(sip), sport, _ip(dip),
                                       dport)

    def on_close(self, lip, lport, rip, rport) -> None:
        self._lib.kdt_ft_close(self._h, _ip(lip), lport, _ip(rip), rport)

    def decide_batch(self, frames: list[bytes], eligible, shaped,
                     lens=None):
        """Bypass verdicts for a whole ingress drain in ONE native call:
        parse + establish + shaped-disable + sk_msg verdict per frame
        (the per-frame semantics of runtime._try_bypass). `eligible` and
        `shaped` are per-frame bool sequences; returns a uint8 array
        where 1 = the frame bypasses shaping. Thin wrapper over the
        fused form with classification disabled — ONE decide
        implementation to keep in sync with the per-frame path."""
        return self.decide_classify_batch(frames, eligible, shaped,
                                          None, lens=lens)[0]

    def decide_classify_batch(self, frames: list[bytes], eligible,
                              shaped, countable, lens=None):
        """decide_batch fused with per-frame protocol classification —
        ONE pointer-array marshal for both outputs (the marshal is a
        third of each call's cost on the tick path). Returns (verdicts
        uint8[n], class_counts dict) where class_counts covers only
        frames with countable=1 (holdback frames were already counted
        on their first pass). countable=None disables classification
        entirely (the plain decide_batch form)."""
        import numpy as np

        n = len(frames)
        if n == 0:
            return np.zeros(0, np.uint8), {}
        ptrs_u64 = frame_ptrs_u64(frames)
        if lens is None:
            lens_a = np.fromiter((len(f) for f in frames), np.uint64,
                                 count=n)
        else:
            lens_a = lens
        return self.decide_classify_ptrs(ptrs_u64, lens_a, eligible,
                                         shaped, countable)

    def decide_classify_ptrs(self, ptrs_u64, lens, eligible, shaped,
                             countable):
        """Core of the fused decide+classify call taking a raw uint64
        frame-pointer array — the zero-copy segment path computes
        pointers as base+offset vector adds, so no per-frame Python
        object is ever touched. The CALLER guarantees every pointed-to
        buffer outlives this call."""
        import numpy as np

        n = len(ptrs_u64)
        out = np.zeros(n, np.uint8)
        if n == 0:
            return out, {}
        ptrs_c = np.ascontiguousarray(ptrs_u64, np.uint64)
        lens_a = np.ascontiguousarray(lens, np.uint64)
        elig = np.ascontiguousarray(eligible, np.uint8)
        shp = np.ascontiguousarray(shaped, np.uint8)
        c = ctypes
        u8p, u64p = c.POINTER(c.c_uint8), c.POINTER(c.c_uint64)
        if countable is None:
            cnt_p = None
            cls = None
            cls_p = None
        else:
            cnt = np.ascontiguousarray(countable, np.uint8)
            cnt_p = cnt.ctypes.data_as(u8p)
            cls = np.empty(n, np.int32)
            cls_p = cls.ctypes.data_as(c.POINTER(c.c_int32))
        self._lib.kdt_ft_decide_classify_batch_ptrs(
            self._h, ptrs_c.ctypes.data_as(c.POINTER(c.c_char_p)),
            lens_a.ctypes.data_as(u64p), n,
            elig.ctypes.data_as(u8p), shp.ctypes.data_as(u8p),
            cnt_p, out.ctypes.data_as(u8p), cls_p)
        stats: dict = {}
        if cls is not None:
            counted = cls[cls >= 0]
            if counted.size:
                counts = np.bincount(counted,
                                     minlength=len(FRAME_TYPES))
                stats = {FRAME_TYPES[i]: int(v)
                         for i, v in enumerate(counts.tolist()) if v}
        return out, stats

    def flag(self, lip, lport, rip, rport) -> int | None:
        v = self._lib.kdt_ft_flag(self._h, _ip(lip), lport, _ip(rip), rport)
        return None if v < 0 else v

    def __len__(self) -> int:
        return self._lib.kdt_ft_size(self._h)

    @property
    def bypassed(self) -> int:
        return self._lib.kdt_ft_bypassed(self._h)

    @property
    def passed(self) -> int:
        return self._lib.kdt_ft_passed(self._h)


class FrameRing:
    """SPSC length-prefixed frame queue."""

    def __init__(self, capacity_bytes: int = 640 * 1024) -> None:
        self._lib = _load()
        self._h = self._lib.kdt_rb_new(capacity_bytes)

    def close(self) -> None:
        if self._h:
            self._lib.kdt_rb_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def push(self, frame: bytes) -> bool:
        return bool(self._lib.kdt_rb_push(self._h, _buf(frame), len(frame)))

    def pop(self, max_len: int = 65536) -> bytes | None:
        out = (ctypes.c_uint8 * max_len)()
        n = self._lib.kdt_rb_pop(self._h, out, max_len)
        if n < 0:
            return None
        return bytes(out[:n])

    def __len__(self) -> int:
        return self._lib.kdt_rb_count(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.kdt_rb_dropped(self._h)


class TimingWheel:
    """Hashed hierarchical timing wheel (native): O(1) schedule/advance
    delay-line release for the real-time data plane. Tokens are opaque
    uint64s; `advance(now_us)` returns every token whose deadline passed,
    time-ordered. `next_due_us()` is a lower bound on the next release —
    safe to sleep until."""

    def __init__(self, tick_us: int = 1000, bits: int = 8,
                 levels: int = 4) -> None:
        self._lib = _load()
        self._h = self._lib.kdt_tw_new(tick_us, bits, levels)
        # advance() drain buffer: one saturated live-plane tick releases
        # ~tens of thousands of tokens, and each refill is a native call
        # plus a frombuffer copy — size it so a typical tick drains in one
        self._out = (ctypes.c_uint64 * 32768)()

    def close(self) -> None:
        if self._h:
            self._lib.kdt_tw_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def schedule(self, when_us: int, token: int) -> None:
        self._lib.kdt_tw_schedule(self._h, max(0, int(when_us)), token)

    def schedule_batch(self, when_us, tokens) -> None:
        """Schedule many (deadline, token) pairs in one native call —
        one lock acquisition per tick instead of per frame. Negative
        deadlines clamp to 0 (already due), matching schedule()."""
        import numpy as np

        w = np.maximum(np.asarray(when_us, np.float64), 0.0) \
            .astype(np.uint64)
        t = np.ascontiguousarray(tokens, np.uint64)
        if w.shape[0] == 0:
            return
        u64p = ctypes.POINTER(ctypes.c_uint64)
        self._lib.kdt_tw_schedule_batch(
            self._h, np.ascontiguousarray(w).ctypes.data_as(u64p),
            t.ctypes.data_as(u64p), w.shape[0])

    def advance(self, now_us: int) -> list[int]:
        return self.advance_np(now_us).tolist()

    def advance_np(self, now_us: int):
        """advance() returning one numpy uint64 array instead of a list
        of Python ints — the release path's per-frame int boxing was
        measurable at bulk rates, and the array form lets the caller
        group tokens by batch with vector ops."""
        import numpy as np

        # clamp BEFORE the c_uint64 coercion: a negative elapsed time (clock
        # skew, synthetic test clocks) would wrap to ~1.8e19 and permanently
        # fast-forward the wheel, releasing everything ever scheduled
        now_us = max(0, int(now_us))
        parts: list = []
        while True:
            n = self._lib.kdt_tw_advance(self._h, now_us, self._out,
                                         len(self._out))
            if n:
                parts.append(np.frombuffer(self._out, dtype=np.uint64,
                                           count=n).copy())
            if n < len(self._out):
                break
        if not parts:
            return np.empty(0, np.uint64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def next_due_us(self) -> int | None:
        v = self._lib.kdt_tw_next_due_us(self._h)
        return None if v == (1 << 64) - 1 else v

    def __len__(self) -> int:
        return self._lib.kdt_tw_size(self._h)
