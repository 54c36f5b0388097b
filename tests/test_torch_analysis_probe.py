"""The port's dispatch probe (kubedtn_tpu_torch/analysis/verify) on the
CPU, held against the JAX package's probe plane
(kubedtn_tpu/analysis/verify/entrypoints.build_probe_plane): the same
ingress for the probe's fed ticks (dispatch.WARMUP_TICKS +
COUNTED_TICKS) and DRAIN_TICKS idle ticks, at depths 1 and 2.

The canonical plane's ind and seq classes draw (jitter, loss), and the
two packages draw from different generators (threefry, Philox), so on
it the draw-independent results are held equal: the TBF pair's frames,
the offered counters, and each row's books. Exactly equal frames and
counters are held on the same three classes with deterministic links.
The probe's wrapper counts are pinned: the unsharded tick reaches no
hand-written kernel, the 4-shard tick K4's wrapper 9 times (3 classes x
3 ring steps)."""

from __future__ import annotations

import numpy as np
import pytest

from kubedtn_tpu.analysis.verify import entrypoints as jentry
from kubedtn_tpu.api import types as jtypes
from kubedtn_tpu_torch.analysis.verify import dispatch
from kubedtn_tpu_torch.analysis.verify import entrypoints as tentry
from kubedtn_tpu_torch.api import types as ttypes

from _torch_native_guard import assert_jax_wheel, ensure_jax_native

COUNTER_FIELDS = ("tx_packets", "tx_bytes", "rx_packets", "rx_bytes",
                  "dropped_loss", "dropped_queue", "rx_corrupted")
# the canonical plane's three classes on deterministic links: no jitter
# and no loss (the seq link keeps a correlation, so it stays sequential)
DET = (dict(latency="3ms"), dict(rate="2Gbit"),
       dict(latency="2ms", latency_corr="25"))
TICKS = dispatch.WARMUP_TICKS + dispatch.COUNTED_TICKS
TBF = 1   # the TBF pair's index


def jax_run(depth: int, det: bool, monkeypatch) -> dict:
    """The JAX probe plane fed as dispatch.probe_plane feeds the port's."""
    if det:
        monkeypatch.setattr(jentry, "_probe_props", lambda: [
            jtypes.LinkProperties(**p) for p in DET])
    assert ensure_jax_native() is None
    plane, win = jentry.build_probe_plane(depth=depth)
    monkeypatch.undo()
    assert_jax_wheel(plane)
    daemon = plane.daemon
    wout = [daemon.wires.get_by_key(f"default/b{i}", i + 1)
            for i in range(len(win))]
    egress = [[] for _ in wout]
    for i in range(TICKS + dispatch.DRAIN_TICKS):
        if i < TICKS:
            for k, w in enumerate(win):
                w.ingress.extend(dispatch.probe_frames(k, i))
        plane.tick(now_s=dispatch.T0_S + (i + 1) * tentry.PROBE_DT_US / 1e6)
        for k, w in enumerate(wout):
            while w.egress:
                egress[k].append(w.egress.popleft())
    plane.flush()
    for k, w in enumerate(wout):
        while w.egress:
            egress[k].append(w.egress.popleft())
    assert plane.tick_errors == 0
    return {"egress": egress,
            "counters": {f: np.asarray(getattr(plane.counters, f))
                         for f in COUNTER_FIELDS}}


def port_run(depth: int, det: bool, shards: int = 0) -> dict:
    props = tentry._probe_props
    if det:
        tentry._probe_props = lambda: [ttypes.LinkProperties(**p)
                                       for p in DET]
    try:
        r = dispatch.probe_plane(depth=depth, shards=shards, device="cpu")
    finally:
        tentry._probe_props = props
    assert r["tick_errors"] == 0
    return r


@pytest.fixture(scope="module")
def port_runs():
    return {(d, det, s): port_run(d, det, s)
            for d in (1, 2) for det in (False, True)
            for s in ((0, 4) if not det else (0,))}


@pytest.mark.parametrize("depth", [1, 2])
def test_probe_plane_equals_jax_on_deterministic_links(depth, port_runs,
                                                       monkeypatch):
    j = jax_run(depth, True, monkeypatch)
    t = port_runs[(depth, True, 0)]
    assert [len(e) for e in t["egress"]] == [len(e) for e in j["egress"]]
    assert t["egress"] == j["egress"]   # bytes and order, every wire
    assert sum(len(e) for e in t["egress"]) == \
        3 * TICKS * dispatch.FEED_FRAMES
    n = len(j["counters"]["tx_packets"])
    for f in COUNTER_FIELDS:
        np.testing.assert_array_equal(t["counters"][f][:n],
                                      j["counters"][f], err_msg=f)


@pytest.mark.parametrize("depth", [1, 2])
def test_probe_plane_equals_jax_where_no_draw_decides(depth, port_runs,
                                                      monkeypatch):
    """The canonical plane: the TBF pair draws nothing, so its frames
    are equal; every row is offered the same frames; every row's books
    close (delivered + dropped == offered) in both packages."""
    j = jax_run(depth, False, monkeypatch)
    t = port_runs[(depth, False, 0)]
    assert t["egress"][TBF] == j["egress"][TBF]
    n = len(j["counters"]["tx_packets"])
    for f in ("tx_packets", "tx_bytes"):
        np.testing.assert_array_equal(t["counters"][f][:n],
                                      j["counters"][f], err_msg=f)
    for c in (t["counters"], j["counters"]):
        np.testing.assert_array_equal(
            c["rx_packets"][:n] + c["dropped_loss"][:n]
            + c["dropped_queue"][:n], c["tx_packets"][:n])
    for run in (t, j):
        assert sum(len(e) for e in run["egress"]) == \
            int(run["counters"]["rx_packets"].sum())


@pytest.mark.parametrize("shards", [0, 4])
def test_probe_depth1_equals_depth2(shards, port_runs):
    """Within the port, on the canonical (drawing) plane: the same
    frames in the same order and the same counters at both depths,
    unsharded and on 4 virtual shards — and the sharded plane equals the
    unsharded one."""
    a, b = port_runs[(1, False, shards)], port_runs[(2, False, shards)]
    base = port_runs[(1, False, 0)]
    for r in (b, base):
        assert r["egress"] == a["egress"]
        for f in COUNTER_FIELDS:
            np.testing.assert_array_equal(r["counters"][f],
                                          a["counters"][f], err_msg=f)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shards", [0, 4])
def test_probe_wrapper_counts_pinned(depth, shards, port_runs):
    r = port_runs[(depth, False, shards)]
    ring = 9 * dispatch.COUNTED_TICKS if shards == 4 else 0
    assert r["calls"] == {"shape_step_rows": 0, "shape_steps_cols": 0,
                          "shape_steps_cols_philox": 0, "ring_step": ring}
    assert r["launches"] is None and r["syncs"] is None   # CPU
    assert r["cuda_kernels"] is None


def test_kernel_calls_count_on_the_cpu():
    """The wrappers count calls on any device (the CPU runs the plain
    versions, which launch nothing), and are restored afterwards."""
    import torch

    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import exchange

    real = shaping.shape_step_flags
    st = es.init_state(8, device="cpu")
    z = torch.zeros(8)
    l0 = dispatch.launch_counts()
    with dispatch.KernelCalls() as kc:
        netem.shape_step_nodonate(st, z, torch.ones(8, dtype=torch.bool), z,
                                  torch.Generator().manual_seed(0))
        exchange.ring_right_shift([torch.zeros(2), torch.ones(2)],
                                  [torch.device("cpu")] * 2)
    assert kc.calls["shape_step_rows"] == 1 and kc.calls["ring_step"] == 1
    assert dispatch.launch_counts() == l0
    assert shaping.shape_step_flags is real


def test_sync_sites_map_to_static_waivers():
    """A sync site on a line the static sync pass waives carries the
    waiver's reason; a site elsewhere carries None."""
    from kubedtn_tpu_torch.analysis import default_root

    root = default_root()
    lines = (root / "kubedtn_tpu_torch/runtime.py").read_text().splitlines()
    mirror = next(i for i, ln in enumerate(lines, 1)
                  if "mirror = state.props.cpu().numpy()" in ln)
    tick = next(i for i, ln in enumerate(lines, 1)
                if ln.strip().startswith("def tick("))
    got = dispatch.waived_sites([
        {"path": "kubedtn_tpu_torch/runtime.py", "line": mirror},
        {"path": "kubedtn_tpu_torch/runtime.py", "line": tick + 1}])
    assert "props generation" in got[0]["waiver"]
    assert got[1]["waiver"] is None


def test_chip_smoke_phase_26_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 26 on the CPU: every check runs (the launch,
    profiler and sync checks pass vacuously without a card)."""
    import torch

    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    m, k4 = cs.run_dispatch_phase(torch.device("cpu"), "cpu")
    assert k4 == 0   # the CPU runs the plain ring
    for part in ("a_depth1", "a_depth2", "b_shards4"):
        assert m[part]["delivered"] == 68 and m[part]["syncs_per_tick"] == 0
    assert m["a_depth1"]["calls_per_tick"] == {}
    assert m["b_shards4"]["calls_per_tick"] == {"ring_step": 9.0}
    assert m["b_shards4"]["k4_cpu_predicted"] == 9 * dispatch.COUNTED_TICKS
