"""The host live plane of the port (runtime.WireDataPlane over the
port's SimEngine and Daemon) against the JAX package's plane, and the
port's own pipeline contracts.

Against JAX, on DETERMINISTIC links (latency, TBF rate with its 50 ms
queue overflow, latency_corr without jitter — no loss, duplicate,
corrupt or reorder probability): the two planes draw different bits
(threefry against Philox), so only links whose results do not depend on
the draws can be compared, and on those every per-wire egress byte
sequence, every release tick and every counter must be equal, at depth 1
and at depth 2, through all three kernel classes, the TBF fallback
re-shape and the seq_slots holdback. Only the `corr` column, which the
draws still move, is left out.

Here also the trap test of the host props mirror: a row whose props
move from the slot-independent class to the TBF class between two ticks.
The port updates props in place, so the mirror must follow the engine's
props generation. test_torch_plane_traps.py holds the other trap tests
(UpdateLinks and compact() while a dispatch is in flight), and
test_torch_plane_contracts.py the port's own pipeline contracts on
random links; both take this file's helpers.

No test reads a wall clock: every tick runs on an explicit clock.
"""

import types

import numpy as np
import pytest

import kubedtn_tpu.api.types as jtypes
import kubedtn_tpu.runtime as jrt
import kubedtn_tpu.topology.engine as jeng
import kubedtn_tpu.topology.reconciler as jrec
import kubedtn_tpu.topology.store as jst
import kubedtn_tpu.wire.server as jsrv
import kubedtn_tpu_torch.api.types as ttypes
import kubedtn_tpu_torch.runtime as trt
import kubedtn_tpu_torch.topology.engine as teng
import kubedtn_tpu_torch.topology.reconciler as trec
import kubedtn_tpu_torch.topology.store as tst
import kubedtn_tpu_torch.wire.server as tsrv
from kubedtn_tpu_torch.ops import netem as tnetem

PKG = {"jax": (jeng, jst, jrec, jsrv, jrt, jtypes),
       "torch": (teng, tst, trec, tsrv, trt, ttypes)}

# one pair of pods per entry; traffic flows a_i -> b_i over link uid i+1
DET_PROPS = (
    dict(latency="10ms"),                       # slot-independent
    dict(rate="1Mbit"),                         # TBF, overflows: fallback
    dict(latency="5ms", latency_corr="30"),     # sequential, holdback
    dict(latency="2ms", rate="20Mbit"),         # TBF without overflow
)
# frames per ingress wire and tick (the seq wire's 70 > seq_slots = 64)
DET_COUNTS = (20, 30, 70, 40)
DT = 0.01
FEED_TICKS = 8
DRAIN_TICKS = 30
COUNTER_FIELDS = ("tx_packets", "tx_bytes", "rx_packets", "rx_bytes",
                  "dropped_loss", "dropped_queue", "rx_corrupted")


def wire_def(pod, uid):
    """A WireDef-shaped object: both Daemons' _add_wire take any object
    with WireDef's attribute names."""
    return types.SimpleNamespace(
        local_pod_name=pod, kube_ns="default", link_uid=uid,
        intf_name_in_pod="eth1", veth_name_local_host="", peer_intf_id=0,
        peer_ip="")


def build(pkg, props, depth=1, capacity=64, seed=0, telemetry=False):
    eng, st, rec, srv, rt, ty = PKG[pkg]
    store = st.TopologyStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    engine = eng.SimEngine(store, capacity=capacity, **kw)
    for i, p in enumerate(props):
        lp = ty.LinkProperties(**p)
        for a, b in ((f"a{i}", f"b{i}"), (f"b{i}", f"a{i}")):
            store.create(ty.Topology(name=a, spec=ty.TopologySpec(links=[
                ty.Link(local_intf="eth1", peer_intf="eth1", peer_pod=b,
                        uid=i + 1, properties=lp)])))
        engine.setup_pod(f"a{i}")
        engine.setup_pod(f"b{i}")
    rec.Reconciler(store, engine).drain()
    daemon = srv.Daemon(engine)
    plane = rt.WireDataPlane(daemon, dt_us=DT * 1e6, seed=seed,
                             pipeline_depth=depth)
    plane.pipeline_explicit_clock = True
    if telemetry:
        plane.enable_telemetry(window_s=10.0, sample_period=8)
    win = [daemon._add_wire(wire_def(f"a{i}", i + 1))
           for i in range(len(props))]
    wout = [daemon._add_wire(wire_def(f"b{i}", i + 1))
            for i in range(len(props))]
    return types.SimpleNamespace(store=store, engine=engine, daemon=daemon,
                                 plane=plane, win=win, wout=wout, ty=ty)


def frames_for(k, t, n, rng):
    """n tagged frames of wire k at tick t: the first bytes encode
    (wire, tick, index), the sizes are drawn (64..1500 bytes)."""
    sizes = rng.integers(64, 1501, n)
    return [bytes([k, t]) + j.to_bytes(2, "big") + b"\x5a" * (int(s) - 4)
            for j, s in enumerate(sizes)]


def drive(sc, counts=DET_COUNTS, feed_ticks=FEED_TICKS,
          drain_ticks=DRAIN_TICKS, seed=1, hook=None):
    """Feed `counts[k]` frames per ingress wire k for `feed_ticks`
    explicit-clock ticks, then tick until `drain_ticks` more have passed;
    `hook(sc, t)` runs before tick t. Returns the per-wire egress as
    [(tick, frame)] lists."""
    rng = np.random.default_rng(seed)
    got = [[] for _ in sc.wout]
    for t in range(feed_ticks + drain_ticks):
        if hook is not None:
            hook(sc, t)
        if t < feed_ticks:
            for k, w in enumerate(sc.win):
                w.ingress.extend(frames_for(k, t, counts[k], rng))
        sc.plane.tick(now_s=(t + 1) * DT)
        for k, w in enumerate(sc.wout):
            while w.egress:
                got[k].append((t, w.egress.popleft()))
    assert sc.plane.tick_errors == 0
    assert not sc.plane._inflight
    return got


def counters(plane):
    return {f: np.asarray(getattr(plane.counters, f))
            for f in COUNTER_FIELDS}


def state_cols(engine, n):
    st = engine.state
    out = {}
    for f in ("tokens", "t_last", "backlog_until", "pkt_count", "props",
              "active", "uid"):
        x = getattr(st, f)
        out[f] = np.asarray(x.cpu() if hasattr(x, "cpu") else x)[:n]
    return out


def assert_same_run(rj, rt_):
    (gj, pj, ej), (gt, pt, et) = rj, rt_
    assert [len(w) for w in gj] == [len(w) for w in gt]
    for wj, wt in zip(gj, gt):
        assert wj == wt  # bytes, order and release tick
    assert (pj.shaped, pj.dropped, pj.ticks) == (pt.shaped, pt.dropped,
                                                 pt.ticks)
    cj, ct = counters(pj), counters(pt)
    n = len(cj["tx_packets"])
    for f in COUNTER_FIELDS:
        np.testing.assert_array_equal(cj[f], ct[f][:n], err_msg=f)
    sj, s_t = state_cols(ej, n), state_cols(et, n)
    for f in sj:
        np.testing.assert_array_equal(sj[f], s_t[f], err_msg=f)


def run_pkg(pkg, depth, **kw):
    sc = build(pkg, DET_PROPS, depth=depth)
    got = drive(sc, **kw)
    return got, sc.plane, sc.engine


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX plane's runs, once per module (its first ticks compile)."""
    return {d: run_pkg("jax", d) for d in (1, 2)}


# -- against JAX, on deterministic links ------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_plane_equals_jax_on_deterministic_links(jax_runs, depth):
    rt_ = run_pkg("torch", depth)
    assert_same_run(jax_runs[depth], rt_)
    got, plane, _ = rt_
    assert all(len(w) > 0 for w in got)  # every class delivered
    assert plane.fallbacks > 0          # the TBF fallback re-shape ran
    assert plane.dropped > 0            # and dropped at the 50ms queue


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_seq_holdback_matches_jax(jax_runs, depth):
    """The seq wire feeds 70 > seq_slots frames a tick: its residue
    waits in the holdback and shapes first on the next tick — the
    release ticks of that wire, in order, equal JAX's."""
    got, _, _ = run_pkg("torch", depth)
    seq = [t for t, _f in got[2]]
    assert seq == [t for t, _f in jax_runs[depth][0][2]]
    # the frames of one tick's feed span more than one release tick
    assert len(set(seq)) > FEED_TICKS


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_release_ticks_follow_latency(jax_runs, depth):
    """The 10 ms link releases each tick's feed one tick of 10 ms later,
    or one more when the float clock puts the deadline a hair past the
    tick (at depth 2 the completion trails by one tick and may add one
    more) — in both packages alike, tick for tick."""
    got, _, _ = run_pkg("torch", depth)
    first = {}
    for t, f in got[0]:
        first.setdefault(f[1], t)
    lags = (1, 2) if depth == 1 else (1, 2, 3)
    assert sorted(first) == list(range(FEED_TICKS))
    assert all(first[k] - k in lags for k in first)
    assert got[0] == jax_runs[depth][0][0]


def test_plane_depth1_depth2_same_bytes_deterministic(jax_runs):
    g1, _, _ = jax_runs[1]
    g2, _, _ = run_pkg("torch", 2)
    for w1, w2 in zip(g1, g2):
        assert [f for _t, f in w1] == [f for _t, f in w2]


# -- trap test: the host props mirror --------------------------------------

def update_hook(tick, link, props):
    """Before tick `tick`: one UpdateLinks of pair `link` on its a-side
    CR (the ingress direction), through the engine as the Daemon's
    handler calls it."""
    def hook(sc, t):
        if t != tick:
            return
        topo = sc.engine.get_pod(f"a{link}")
        lp = sc.ty.LinkProperties(**props)
        sc.engine.update_links(topo, [l.with_properties(lp)
                                      for l in topo.spec.links])
    return hook


@pytest.mark.parametrize("depth", [1, 2])
def test_props_mirror_follows_in_place_update(monkeypatch, depth):
    """A row moves from slot-independent props to TBF props between two
    ticks. The port updates props IN PLACE (same tensor), so a mirror
    keyed on tensor identity would keep classifying it as
    slot-independent; keyed on the engine's props generation, the row is
    shaped by the TBF core from the next tick on — and its delivery
    equals JAX's."""
    seen = []
    orig = tnetem.shape_slots_tbf_nodonate

    def spy(state, rows, *a, **kw):
        seen.append(sorted(int(r) for r in rows.tolist()
                           if r < state.capacity))
        return orig(state, rows, *a, **kw)

    monkeypatch.setattr(tnetem, "shape_slots_tbf_nodonate", spy)
    props = (dict(latency="10ms"),)
    runs = {}
    for pkg in ("jax", "torch"):
        sc = build(pkg, props, depth=depth)
        hook = update_hook(2, 0, dict(rate="1Mbit"))
        got = drive(sc, counts=(30,), feed_ticks=4, drain_ticks=30,
                    hook=hook)
        runs[pkg] = (got, sc.plane, sc.engine)
    row = runs["torch"][2].row_of("default/a0", 1)
    assert seen and all(s == [row] for s in seen)
    assert len(seen) == 2  # ticks 2 and 3, after the update
    assert_same_run(runs["jax"], runs["torch"])
