"""The JAX package's native library, held loaded for the port's
cross-package plane tests.

`kubedtn_tpu.native` runs `make -C native` on its first load in every
process, and the Makefile writes `libkubedtn_native.so` in place. Under
pytest-xdist several workers of a fresh tree build it at once; a worker
that loads the library while another is still writing it records
`_build_error` and keeps it for the rest of its life. Its JAX
WireDataPlane then releases frames from `heapq` instead of the native
TimingWheel, on other ticks than the port's plane, which always uses the
wheel. A comparison of the two would then be a comparison of two
different release structures.

`ensure_jax_native()` takes an exclusive `fcntl` lock on a file in the
system temp dir (so the processes that go through it load one at a
time), clears a latched `_build_error` and loads again, a bounded number
of times with short pauses: the other worker's build ends in seconds.
`assert_jax_wheel(plane)` is what a test states after building a JAX
plane: it fails, naming the cause, when the plane has no wheel.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
import time

from kubedtn_tpu import native as jnative

LOCK_PATH = os.path.join(tempfile.gettempdir(),
                         "kubedtn_tpu_native_load.lock")
LOAD_ATTEMPTS = 40
LOCK_ATTEMPTS = 240
PAUSE_S = 0.25


def _lock(fd: int) -> bool:
    """Take the exclusive lock, waiting at most LOCK_ATTEMPTS pauses."""
    for _ in range(LOCK_ATTEMPTS):
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return True
        except BlockingIOError:
            time.sleep(PAUSE_S)
    return False


def ensure_jax_native() -> str | None:
    """Load kubedtn_tpu.native, clearing a latched build error first.
    Returns None once the library is loaded, else the last error."""
    fd = os.open(LOCK_PATH, os.O_CREAT | os.O_RDWR, 0o666)
    try:
        locked = _lock(fd)
        try:
            for _ in range(LOAD_ATTEMPTS):
                with jnative._lock:
                    if jnative._lib is None:
                        jnative._build_error = None
                if jnative.have_native():
                    return None
                time.sleep(PAUSE_S)
            return jnative._build_error or "not loaded"
        finally:
            if locked:
                fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


def assert_jax_wheel(plane) -> None:
    """A JAX WireDataPlane must have its native TimingWheel: without it
    the plane releases from heapq, which the port's plane never does."""
    assert plane._wheel is not None, (
        "the JAX WireDataPlane has no TimingWheel: kubedtn_tpu.native is "
        f"unavailable ({jnative._build_error!r}), most likely because "
        "another process was writing native/libkubedtn_native.so while "
        "this one loaded it; a heapq plane cannot be compared with the "
        "port's wheel plane")
