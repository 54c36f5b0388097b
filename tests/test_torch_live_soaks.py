"""The live-plane soaks of kubedtn_tpu_torch.scenarios on the CPU:
`live_plane`, `live_plane_soak` (latency and TBF wires) and
`staged_update_soak`, each at the size of the JAX package's own smoke
test and asserting what that asserts, and the five live-plane scenarios
held against the JAX package where a wall clock does not decide the
answer: their defaults, the keys they return, the engine and wires that
`_live_plane_setup` realises, and the bytes the injector child streams.

The injector child must import neither torch nor jax nor the JAX
package: the source is read with `ast`, and a child started as the
scenarios start it runs under `python -X importtime`, whose stderr
names every module it imported.
"""

import ast
import inspect
import os
import subprocess
import sys
import time
from concurrent import futures
from pathlib import Path

import numpy as np
import pytest
import torch

from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch import scenarios as tsc
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.wire import proto as tpb

from _torch_native_guard import assert_jax_wheel, ensure_jax_native

SOAKS = ("live_plane", "live_plane_soak", "chaos_soak",
         "staged_update_soak", "update_under_flap")


def returned_keys(module, name: str) -> set:
    """The keys of the dict literal that `name` in `module`'s source
    returns, read with ast (the scenario is not run)."""
    tree = ast.parse(Path(module.__file__).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    rets = [n.value for n in ast.walk(fn)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(rets) == 1, f"{module.__name__}.{name}: {len(rets)} dicts"
    return {k.value for k in rets[0].keys}


def assert_jax_keys(r: dict, name: str) -> None:
    assert set(r) == returned_keys(jsc, name) | {"device"}, (
        set(r) ^ (returned_keys(jsc, name) | {"device"}))
    assert r["device"] == "cpu"


# -- smoke runs (tests/test_batch_plane.py's sizes and assertions) ---------

def test_live_plane_scenario_smoke():
    r = tsc.live_plane(pairs=2, frames_per_wire=1_000, rounds=1,
                       timeout_s=120.0, device="cpu")
    assert_jax_keys(r, "live_plane")
    assert r["tick_errors"] == 0
    assert r["dropped"] == 0
    assert r["frames_per_s"] > 0
    # the injector rounds up to whole INJECTOR_CHUNK batches
    assert r["frames_delivered"] == 2 * 1024


@pytest.mark.parametrize("kw", [{}, {"rate": "2Gbit", "chunk": 512}],
                         ids=["latency", "tbf"])
def test_live_plane_soak_smoke(kw):
    r = tsc.live_plane_soak(pairs=2, seconds=3.0, window_s=1.0,
                            device="cpu", **kw)
    assert_jax_keys(r, "live_plane_soak")
    assert r["dropped"] == 0 and r["tick_errors"] == 0
    assert len(r["windows_frames_per_s"]) >= 2
    assert r["sustained_frames_per_s"] > 0
    assert all(w > 0 for w in r["windows_frames_per_s"])
    assert r["injector_chunk"] == kw.get("chunk", tsc.INJECTOR_CHUNK)
    assert r["shaping"] == (f"rate={kw['rate']}" if kw
                            else "latency=5ms")


def test_staged_update_soak_smoke():
    r = tsc.staged_update_soak(pairs=2, steady_s=1.0, staging_s=1.0,
                               gate_ticks=60, device="cpu")
    assert_jax_keys(r, "staged_update_soak")
    assert r["frames_fed"] > 0
    assert r["frames_lost"] == 0, r
    assert r["tick_errors"] == 0, r
    assert r["clean_plans_verified"] == r["clean_plans"] == 2, r
    assert r["rounds_staged"] > 0, r
    assert r["regressing_rejected"], r
    assert r["regressing_reason"], r
    assert r["gate_left_plane_untouched"], r


# -- held against the JAX package -------------------------------------------

@pytest.mark.parametrize("name", SOAKS)
def test_defaults_equal_jax(name):
    jp = inspect.signature(getattr(jsc, name)).parameters
    tp = inspect.signature(getattr(tsc, name)).parameters
    assert list(tp) == [*jp, "device"]
    for k, p in jp.items():
        assert tp[k].default == p.default, k
    assert tp["device"].default is None


@pytest.mark.parametrize("name", SOAKS)
def test_returned_keys_equal_jax(name):
    assert returned_keys(tsc, name) == returned_keys(jsc, name) | {"device"}


@pytest.mark.parametrize("rate", ["", "2Gbit"], ids=["latency", "tbf"])
def test_live_plane_setup_realises_jax_engine(rate):
    """The same rows (the engine's (pod, uid) -> row map), props columns
    and wire ids as JAX's `_live_plane_setup`, for latency and TBF."""
    assert ensure_jax_native() is None
    j = t = None
    try:
        j = jsc._live_plane_setup(2, "5ms", 2_000.0, "sk", rate=rate)
        assert_jax_wheel(j[3])
        t = tsc._live_plane_setup(2, "5ms", 2_000.0, "sk", rate=rate,
                                  device="cpu")
        je, te = j[0].engine, t[0].engine
        assert te._rows == je._rows
        js, ts = je.state, convert.edge_state_to_numpy(te.state)
        assert ts["props"].shape == np.asarray(js.props).shape
        for f in ("uid", "src", "dst", "active", "props"):
            np.testing.assert_array_equal(ts[f], np.asarray(getattr(js, f)),
                                          err_msg=f)
        for k in (4, 5):   # wires_in, wires_out
            assert [w.wire_id for w in t[k]] == [w.wire_id for w in j[k]]
        col = es.P_RATE_BPS if rate else es.P_LATENCY_US
        assert (ts["props"][ts["active"], col] > 0).all()
    finally:
        for parts in (j, t):
            if parts is not None:
                parts[3].stop()
                parts[1].stop(0)


def test_cpu_plane_runs_on_one_intraop_thread():
    """While a CPU plane's runner is live, torch runs one intra-op
    thread (runtime._CPUThreadCap): the default pool, a thread per core
    in every process, stalled the runners of several soaks sharing a
    host. Planes nest, and the last stop restores the count."""
    n = torch.get_num_threads()
    a = tsc._live_plane_setup(1, "5ms", 2_000.0, "ta", device="cpu")
    try:
        assert torch.get_num_threads() == 1
        b = tsc._live_plane_setup(1, "5ms", 2_000.0, "tb", device="cpu")
        b[3].stop()
        b[1].stop(0)
        assert torch.get_num_threads() == 1     # a still runs
    finally:
        a[3].stop()
        a[1].stop(0)
    assert torch.get_num_threads() == n


def recording_server():
    """A gRPC server on 127.0.0.1 whose InjectBulk records each raw
    request message. Returns (server, port, messages)."""
    import grpc

    got = []

    def inject_bulk(requests, _ctx):
        for b in requests:
            got.append(b)
        return tpb.BoolResponse(response=True).SerializeToString()

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "proto.v1.WireProtocol",
        {"InjectBulk": grpc.stream_unary_rpc_method_handler(inject_bulk)}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port, got


def test_injector_streams_the_bytes_of_jax_injector():
    """Both injectors, 6 frames a wire on wires 5 and 9 in chunks of 4
    (rounded up to 8 a wire), stream the same PacketBatch messages."""
    streams = []
    for src, env in ((jsc._INJECTOR_SRC, dict(os.environ,
                                              JAX_PLATFORMS="cpu")),
                     (tsc._INJECTOR_SRC, None)):
        server, port, got = recording_server()
        try:
            p = subprocess.run(
                [sys.executable, "-c", src, str(port), "5,9", "6",
                 tsc._REPO_ROOT, "4"], env=env, capture_output=True, text=True,
                timeout=120)
        finally:
            server.stop(0)
        assert p.returncode == 0, p.stderr[-2000:]
        float(p.stdout.strip().splitlines()[-1])   # the timing line
        streams.append(got)
    assert streams[0] == streams[1]
    batches = [tpb.PacketBatch.FromString(b) for b in streams[1]]
    assert [[(q.remot_intf_id, q.frame) for q in b.packets]
            for b in batches] == [[(w, b"\xab" * 200)] * 4
                                  for w in (5, 9, 5, 9)]


def test_injector_source_imports_no_torch_jax_or_jax_package():
    tree = ast.parse(tsc._INJECTOR_SRC)
    mods = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            mods |= {a.name for a in n.names}
        elif isinstance(n, ast.ImportFrom):
            mods.add(n.module)
    assert mods == {"sys", "time", "grpc", "kubedtn_tpu_torch.wire"}
    assert "import proto as pb" in tsc._INJECTOR_SRC


def test_injector_child_loads_no_torch_jax_or_jax_package():
    """A soak-mode child (streaming until killed) run under
    `-X importtime`: once its first message has arrived it is killed,
    and its stderr lists every module it imported."""
    server, port, got = recording_server()
    try:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-c", tsc._INJECTOR_SRC,
             str(port), "5", "-1", tsc._REPO_ROOT, str(tsc.INJECTOR_CHUNK)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 60
        while not got and time.monotonic() < deadline \
                and proc.poll() is None:
            time.sleep(0.02)
        proc.kill()
        _out, err = proc.communicate(timeout=30)
    finally:
        server.stop(0)
    assert got, err[-2000:]
    loaded = {line.split("|")[-1].strip() for line in err.splitlines()
              if line.startswith("import time:")}
    assert "kubedtn_tpu_torch.wire.proto" in loaded and "grpc" in loaded
    roots = {m.split(".")[0] for m in loaded}
    assert not roots & {"torch", "jax", "jaxlib", "kubedtn_tpu"}, roots
