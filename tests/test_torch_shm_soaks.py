"""The shared-memory soaks of kubedtn_tpu_torch.scenarios on the CPU:
`shm_producer_crash` at the size and with the asserts of the JAX
package's chaos smoke (tests/test_chaos_smoke.py), `shm_soak` small
(20,000 frames beside a short gRPC ladder: the exact once-only audit and
a clean producer exit), and the producer child, which must import
neither torch nor jax nor the JAX package: it runs under `python -X
importtime`, whose stderr names every module it imported.

The scenarios need the port's native ring; without a C++ toolchain the
module skips, naming the build error."""

import inspect
import subprocess

import pytest

from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu_torch import native as tnative
from kubedtn_tpu_torch import scenarios as tsc


@pytest.fixture(autouse=True)
def _native():
    try:
        tnative._load()
    except tnative.NativeUnavailable as e:
        pytest.skip(f"the port's native library does not build here: {e}")


@pytest.mark.parametrize("name", ["shm_producer_crash", "shm_soak"])
def test_defaults_equal_jax(name):
    jp = inspect.signature(getattr(jsc, name)).parameters
    tp = inspect.signature(getattr(tsc, name)).parameters
    assert list(tp) == [*jp, "device"]
    for k, p in jp.items():
        assert tp[k].default == p.default, k
    assert tp["device"].default is None


def test_shm_producer_crash_smoke():
    """A real producer child SIGKILLed mid-burst: the delivered indices
    an exact prefix covering every progress report, the torn tail
    skipped, the dead ring retired, a producer-minted trace spanning
    received -> ingress -> delivered."""
    r = tsc.shm_producer_crash(frames=1_200, kill_after=400,
                               drain_timeout_s=20.0, device="cpu")
    assert r["device"] == "cpu"
    assert r["reported_at_kill"] >= 400, r
    assert r["delivered_prefix_ok"], r
    assert r["committed_lost"] == 0, r
    assert r["delivered"] >= r["reported_at_kill"], r
    assert r["torn_skipped"] > 0, r
    assert r["ring_pending_final"] == 0, r
    assert r["rings_retired"] == 1, r
    assert r["trace_ok"], r
    assert r["tick_errors"] == 0 and r["dropped"] == 0, r
    assert r["in_guardrails"], r


def test_shm_soak_small_audit_exact():
    r = tsc.shm_soak(frames=20_000, grpc_unary_n=200, grpc_stream_n=2_000,
                     grpc_bulk_n=5_000, device="cpu")
    assert r["device"] == "cpu" and r["scenario"] == "shm_soak"
    assert r["shm_frames_ingested"] == 20_000
    assert r["shm_audit_exact_once"], r
    assert r["producer_rc"] == 0, r
    assert r["shm_frames_per_s"] > 0 and r["shm_dequeues"] > 0
    for k in ("grpc_unary_frames_per_s", "grpc_stream_frames_per_s",
              "grpc_bulk_frames_per_s"):
        assert r[k] > 0, k
    assert r["in_guardrails"] == (r["shm_over_grpc_stream"] >= 10.0)


def test_producer_child_imports_no_torch_or_jax(tmp_path, monkeypatch):
    """The producer as the scenarios start it (`_producer`), with
    PYTHONPROFILEIMPORTTIME set (`-X importtime`): it pushes its frames
    and exits 0, and no module of torch, jax or the JAX package was
    imported."""
    from kubedtn_tpu_torch.shm import ShmRing

    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    ring = str(tmp_path / "p.ring")
    proc = tsc._producer(ring, 7, 500, "--frame-size", 64, "--batch", 32,
                         stdout=subprocess.PIPE)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert out.strip().splitlines()[-1] == "done pushed=500"
    loaded = {line.split("|")[-1].strip() for line in err.splitlines()
              if line.startswith("import time:")}
    assert {"kubedtn_tpu_torch.shm.ring",
            "kubedtn_tpu_torch.shm.sender"} <= loaded
    roots = {m.split(".")[0] for m in loaded}
    assert not roots & {"torch", "jax", "jaxlib", "kubedtn_tpu"}, \
        sorted(roots & {"torch", "jax", "jaxlib", "kubedtn_tpu"})
    r = ShmRing.attach(ring)
    try:
        assert r.committed() == 500
    finally:
        r.close()
