"""The guard of the port's cross-package plane tests against a latched
native build error of the JAX package (tests/_torch_native_guard.py).

A worker that loaded `libkubedtn_native.so` while another was writing it
keeps `kubedtn_tpu.native._build_error` for the rest of its life, and its
JAX WireDataPlane releases frames from heapq. These tests put a process
in that state on purpose and show that the guard brings the library
back, so the plane tests compare wheel with wheel, and that a heapq
plane is refused by name rather than compared.
"""

import pytest

from kubedtn_tpu import native as jnative

from _torch_native_guard import assert_jax_wheel, ensure_jax_native
from test_torch_plane import DET_PROPS, assert_same_run, build, drive


@pytest.fixture
def latched():
    """This process as a racing worker left it: no library loaded and a
    build error latched. Restored (loaded) afterwards."""
    assert ensure_jax_native() is None
    with jnative._lock:
        saved = jnative._lib
        jnative._lib = None
        jnative._build_error = ("native load failed: simulated: another "
                                "process was writing the library")
    yield
    with jnative._lock:
        jnative._lib = saved
        jnative._build_error = None
    assert ensure_jax_native() is None


def test_latched_error_makes_a_heap_plane_and_the_check_names_it(latched):
    assert not jnative.have_native()
    from kubedtn_tpu import runtime as jrt
    from kubedtn_tpu.topology.engine import SimEngine
    from kubedtn_tpu.topology.store import TopologyStore
    from kubedtn_tpu.wire.server import Daemon

    plane = jrt.WireDataPlane(Daemon(SimEngine(TopologyStore(),
                                               capacity=8)))
    assert plane._wheel is None
    with pytest.raises(AssertionError, match="no TimingWheel"):
        assert_jax_wheel(plane)


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_tests_recover_from_a_latched_error(latched, depth):
    """After the latch, the plane tests' own `build` goes through the
    guard: the JAX plane has its wheel again and its run equals the
    port's, release ticks included."""
    assert not jnative.have_native()
    sc_j = build("jax", DET_PROPS, depth=depth)
    assert sc_j.plane._wheel is not None
    assert jnative.have_native() and jnative._build_error is None
    sc_t = build("torch", DET_PROPS, depth=depth)
    assert_same_run((drive(sc_j), sc_j.plane, sc_j.engine),
                    (drive(sc_t), sc_t.plane, sc_t.engine))


def test_guard_reports_an_error_it_cannot_clear(monkeypatch):
    """A library that stays unloadable is reported after the bounded
    attempts, not waited on forever."""
    import _torch_native_guard as guard

    monkeypatch.setattr(guard, "LOAD_ATTEMPTS", 2)
    monkeypatch.setattr(guard, "PAUSE_S", 0.0)
    with jnative._lock:
        saved = jnative._lib
        jnative._lib = None

    def broken():
        jnative._build_error = "native load failed: still broken"
        raise jnative.NativeUnavailable(jnative._build_error)

    monkeypatch.setattr(jnative, "_load", broken)
    try:
        assert guard.ensure_jax_native() == \
            "native load failed: still broken"
    finally:
        monkeypatch.undo()
        with jnative._lock:
            jnative._lib = saved
            jnative._build_error = None


def test_native_bindings_recover_from_a_latched_error(latched):
    """The bindings test_torch_native.py compares against: unusable while
    latched, usable after the guard."""
    with pytest.raises(jnative.NativeUnavailable):
        jnative.TimingWheel(tick_us=1000)
    assert ensure_jax_native() is None
    wheel = jnative.TimingWheel(tick_us=1000)
    wheel.schedule(5, 2500)
    assert len(wheel) == 1
