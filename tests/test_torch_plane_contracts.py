"""The port's live plane against itself on random links: the contracts
of tests/test_pipeline_determinism.py and tests/test_drop_causes.py
re-pinned on the torch plane (depth 1 ≡ depth 2, telemetry on ≡ off,
ladder rung 2 ≡ fused, sharded on 2 and 4 virtual CPU shards ≡
unsharded, the drop-cause partition, the adaptive budget's bounds, the
flush barrier of stop() and fast_forward()), plus the bypass path
against the JAX plane. No test reads a wall clock.
"""

import numpy as np
import pytest

import kubedtn_tpu_torch.telemetry as ttele
from test_torch_plane import build


INDEP = dict(latency="3ms", jitter="1ms", loss="5")
TBF = dict(rate="2Gbit")
TBF_OVERLOAD = dict(rate="512Kbit")
SEQ = dict(latency="2ms", loss="10", loss_corr="25")
CLASSES = {"indep": (INDEP, 200, {}), "tbf": (TBF, 200, {}),
           "tbf-fallback": (TBF_OVERLOAD, 300, {}),
           "seq-holdback": (SEQ, 150, dict(seq_slots=16))}


def run_random(props, n, depth=1, pairs=2, ticks=40, dt=0.002,
               seq_slots=64, feed_every=None, telemetry=False,
               ladder=None, shards=None):
    """tests/test_pipeline_determinism.py's _run_plane on the port: an
    identical deterministic schedule through one freshly-built plane;
    returns the per-wire egress and the plane."""
    sc = build("torch", [props] * pairs, depth=depth, capacity=4 * pairs + 8,
               telemetry=telemetry)
    plane = sc.plane
    plane.seq_slots = seq_slots
    if shards:
        plane.enable_sharding(n_devices=shards)
    t = 100.0
    tag = lambda k, m: [bytes([k]) + i.to_bytes(4, "big") + b"\0" * 59
                        for i in range(m)]
    for k, w in enumerate(sc.win):
        w.ingress.extend(tag(k, n))
    for j in range(ticks):
        if ladder and j in ladder:
            plane.force_degrade(ladder[j])
        if feed_every and j and j % feed_every == 0:
            for k, w in enumerate(sc.win):
                w.ingress.extend(tag(k, n))
        t += dt
        plane.tick(now_s=t)
    plane.flush()
    plane.tick(now_s=t + 10.0)
    assert plane.tick_errors == 0
    assert not plane._inflight
    return [list(w.egress) for w in sc.wout], plane


def same_delivery(a, b):
    (g1, p1), (g2, p2) = a, b
    assert (p1.shaped, p1.dropped) == (p2.shaped, p2.dropped)
    for w1, w2 in zip(g1, g2):
        assert w1 == w2
    assert sum(len(w) for w in g1) > 0


@pytest.mark.parametrize("cls", list(CLASSES))
def test_depth2_matches_depth1(cls):
    props, n, kw = CLASSES[cls]
    same_delivery(run_random(props, n, 1, **kw),
                  run_random(props, n, 2, **kw))


@pytest.mark.parametrize("cls", ["indep", "tbf-fallback", "seq-holdback"])
def test_telemetry_on_matches_off(cls):
    props, n, kw = CLASSES[cls]
    on1 = run_random(props, n, 1, telemetry=True, **kw)
    on2 = run_random(props, n, 2, telemetry=True, **kw)
    off = run_random(props, n, 2, **kw)
    same_delivery(on1, on2)
    same_delivery(off, on2)
    assert on1[1].recorder.sampled == on2[1].recorder.sampled > 0


@pytest.mark.parametrize("cls", list(CLASSES))
def test_ladder_rung2_matches_fused(cls):
    """The degradation ladder active mid-stream (depth 2 → 1 → the
    per-class rung 2 → back up) delivers what depth 1 delivers."""
    props, n, kw = CLASSES[cls]
    ref = run_random(props, n // 4, 1, feed_every=5, **kw)
    lad = run_random(props, n // 4, 2, feed_every=5,
                     ladder={8: 1, 16: 2, 24: 1, 30: 0}, **kw)
    same_delivery(ref, lad)
    assert lad[1].degradations == 2 and lad[1].promotions == 2


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("cls", ["indep", "tbf-fallback", "seq-holdback"])
def test_sharded_matches_unsharded(cls, shards):
    props, n, kw = CLASSES[cls]
    ref = run_random(props, n, 2, pairs=4, **kw)
    sh = run_random(props, n, 2, pairs=4, shards=shards, **kw)
    same_delivery(ref, sh)
    summ = sh[1].shard_summary()
    assert summ["enabled"] and summ["n_shards"] == shards
    assert summ["mailbox_hwm"] > 0


RAND_SPECS = [
    dict(latency="2ms", loss="30", loss_corr="40"),
    dict(latency="1ms", jitter="500us", duplicate="20", corrupt_prob="10"),
    dict(rate="300Kbit", loss="5"),
    dict(latency="3ms", reorder_prob="20", gap=2, rate="3Mbit"),
    dict(jitter="900us", loss="15"),
]


@pytest.mark.parametrize("depth", [1, 2])
def test_drop_causes_partition(depth):
    """Per edge rx + loss + queue == tx; shaped + dropped == fed; the
    window ring agrees with the counters (fallback path included)."""
    rng = np.random.default_rng(23)
    sc = build("torch", RAND_SPECS, depth=depth, capacity=32)
    plane = sc.plane
    tel, _rec = plane.enable_telemetry(window_s=10.0, sample_period=16)
    fed = 0
    t = 100.0
    for _burst in range(3):
        for k, w in enumerate(sc.win):
            m = int(rng.integers(20, 200))
            w.ingress.extend([bytes([k]) + b"\x00" * 199] * m)
            fed += m
        for _ in range(15):
            t += 0.002
            plane.tick(now_s=t)
    plane.flush()
    plane.tick(now_s=t + 10.0)
    assert plane.tick_errors == 0
    c = plane.counters
    tx, rx = c.tx_packets, c.rx_packets
    loss, queue = c.dropped_loss, c.dropped_queue
    assert tx.sum() == fed
    assert rx.sum() == plane.shaped
    assert loss.sum() + queue.sum() == plane.dropped
    assert plane.shaped + plane.dropped == fed
    np.testing.assert_array_equal(rx + loss + queue, tx)
    assert loss.sum() > 0 and queue.sum() > 0
    total, _secs = tel.window_sum()
    assert total[:, ttele.T_TX].sum() == fed
    assert total[:, ttele.T_DELIVERED].sum() == plane.shaped
    np.testing.assert_allclose(total[:, ttele.T_DROP_LOSS], loss)
    np.testing.assert_allclose(total[:, ttele.T_DROP_QUEUE], queue)
    assert total[:, ttele.T_HIST0:].sum() == plane.shaped


def test_adaptive_budget_stays_in_bounds():
    sc = build("torch", [INDEP])
    plane, daemon = sc.plane, sc.daemon
    assert plane._drain_budget == plane.max_slots
    daemon.last_drain_backlog = 0
    for _ in range(40):
        plane._adapt_budget()
        assert plane.adapt_min_slots <= plane._drain_budget \
            <= plane.max_slots
    assert plane._drain_budget == plane.adapt_min_slots
    for bl in range(1, 41):
        daemon.last_drain_backlog = bl * 100
        plane._adapt_budget()
        assert plane.adapt_min_slots <= plane._drain_budget \
            <= plane.max_slots
    assert plane._drain_budget == plane.max_slots
    assert plane.last_backlog == 4000


def test_stop_flushes_inflight_dispatch():
    sc = build("torch", [dict(latency="100ms")], depth=2)
    sc.win[0].ingress.extend([bytes([i]) * 64 for i in range(30)])
    sc.plane.tick(now_s=3.0)
    assert sc.plane._inflight  # depth 2: the dispatch is in flight
    sc.plane.stop()            # runner never started — must still flush
    assert not sc.plane._inflight
    assert sc.plane.shaped == 30
    assert len(sc.plane._wheel) == 30


def test_fast_forward_flushes_pipelined_ticks():
    results = []
    for depth in (1, 2):
        sc = build("torch", [INDEP], depth=depth)
        sc.win[0].ingress.extend([i.to_bytes(2, "big") * 32
                                  for i in range(120)])
        r = sc.plane.fast_forward(1.0)
        assert not sc.plane._inflight
        results.append((r["shaped"], list(sc.wout[0].egress)))
    (s1, d1), (s2, d2) = results
    assert s1 == s2 and d1 == d2 and len(d1) > 0


def test_stage_breakdown_and_health():
    sc = build("torch", [INDEP], depth=2)
    sc.win[0].ingress.extend([b"\x01" * 64] * 10)
    sc.plane.tick(now_s=1.0)
    sc.plane.flush()
    bd = sc.plane.stage_breakdown()
    assert set(bd["seconds"]) == {"drain", "decide", "kernel", "sync",
                                  "schedule", "release"}
    assert abs(sum(bd["share"].values()) - 1.0) < 0.01
    assert bd["pipeline"]["depth"] == 2
    h = sc.daemon.health_snapshot()
    assert h["serving"] and h["active_rows"] == 2 and h["ticks"] == 1


def test_bypass_same_node_unshaped_tcp():
    """A same-node TCP flow over an UNSHAPED link short-circuits the
    shaping (the eBPF sockops/redir role); over a shaped link it is
    shaped, and stays disabled."""
    import struct

    def tcp(sport):
        eth = b"\x00" * 12 + b"\x08\x00"
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 40, 0, 0, 64, 6, 0,
                         bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]))
        return eth + ip + struct.pack(">HHIIHHHH", sport, 80, 0, 0, 0x5010,
                                      0, 0, 0) + b"\0" * 6

    res = {}
    for pkg in ("jax", "torch"):
        sc = build(pkg, [dict(), dict(latency="1ms")])
        for k in range(2):
            sc.win[k].ingress.extend([tcp(1000 + k)] * 5)
        sc.plane.tick(now_s=1.0)
        first = [len(w.egress) for w in sc.wout]
        sc.plane.tick(now_s=1.01)
        res[pkg] = (sc.plane.bypassed, first,
                    [list(w.egress) for w in sc.wout],
                    dict(sc.daemon.frame_stats))
    assert res["torch"] == res["jax"]
    bypassed, first, _eg, stats = res["torch"]
    assert bypassed > 0 and first[1] == 0  # shaped: waits its 1 ms
    assert stats["TCP"] == 10


def test_flow_stats_match_jax_through_the_bypass():
    """tests/test_runtime.py's bypass sequence on an unshaped link: the
    first TCP message takes the shaped path, the next one bypasses in
    the same tick; WireDataPlane.flow_stats == the JAX plane's dict after
    each tick, and after the flow is disabled by a shaped crossing."""
    import struct

    eth = b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00"
    ip = struct.pack(">BBHHHBBHII", 0x45, 0, 40, 7, 0, 64, 6, 0,
                     0x0A000001, 0x0A000002)
    f = eth + ip + struct.pack(">HHIIBBHHH", 40000, 5201, 1, 0, 0x50, 0x18,
                               8192, 0, 0)
    res = {}
    for pkg in ("jax", "torch"):
        sc = build(pkg, [dict()])
        seen = [sc.plane.flow_stats]
        for t in (10.0, 10.001):
            sc.win[0].ingress.append(f)
            sc.plane.tick(now_s=t)
            seen.append(sc.plane.flow_stats)
        row = sc.engine.row_of("default/a0", 1)
        sc.plane._try_bypass(row, f, ("default/b0", 1), {row})
        seen.append(sc.plane.flow_stats)
        res[pkg] = (seen, sc.plane.bypassed)
    assert res["torch"] == res["jax"]
    seen, bypassed = res["torch"]
    assert bypassed == 1 and seen[2]["bypassed"] == 1
    assert seen[0] == {"available": True, "flows": 0, "bypassed": 0,
                       "passed": 0}


def test_try_bypass_per_frame_matches_jax():
    """The per-frame bypass verdict (the batched decision's per-frame
    form): a same-node TCP frame over an unshaped row bypasses, over a
    shaped row it disables the flow for good; non-TCP never bypasses."""
    import struct

    def tcp(sport):
        eth = b"\x00" * 12 + b"\x08\x00"
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 40, 0, 0, 64, 6, 0,
                         bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]))
        return eth + ip + struct.pack(">HHIIHHHH", sport, 80, 0, 0,
                                      0x5010, 0, 0, 0) + b"\0" * 6

    res = {}
    for pkg in ("jax", "torch"):
        sc = build(pkg, [dict()])
        row = sc.engine.row_of("default/a0", 1)
        target = ("default/b0", 1)
        out = [sc.plane._try_bypass(row, tcp(7), target, set()),
               sc.plane._try_bypass(row, tcp(7), target, set()),
               sc.plane._try_bypass(row, tcp(8), target, {row}),
               sc.plane._try_bypass(row, tcp(8), target, set()),
               sc.plane._try_bypass(row, b"\x00" * 64, target, set()),
               sc.plane._try_bypass(row, tcp(9), None, set())]
        res[pkg] = (out, sc.plane.bypassed, len(sc.wout[0].egress))
    assert res["torch"] == res["jax"]
    # the first frame establishes the flow, the next one is redirected;
    # a flow seen crossing a shaped row never is again
    assert res["torch"] == ([False, True, False, False, False, False], 1,
                            1)


def _random_load(props, depth, seed=1, ticks=16, drain=14):
    """1..64 frames of 64..256 bytes per ingress wire and tick, as
    chip_smoke.py's phase 12 feeds them."""
    sc = build("torch", props, depth=depth)
    rng = np.random.default_rng(seed)
    got = [[] for _ in sc.wout]
    for t in range(ticks + drain):
        if t < ticks:
            for k, w in enumerate(sc.win):
                w.ingress.extend(
                    bytes([k, t, j]) + b"z" * int(s)
                    for j, s in enumerate(rng.integers(61, 254, int(
                        rng.integers(1, 65)))))
        sc.plane.tick(now_s=(t + 1) * 0.01)
        for k, w in enumerate(sc.wout):
            got[k].extend(w.egress)
            w.egress.clear()
    assert not sc.plane._inflight and len(sc.plane._wheel) == 0
    return got, sc.plane


TBF_ONLY = [dict(latency="1ms", rate="1Mbit"), dict(rate="800Kbit"),
            dict(latency="2ms", rate="20Mbit"), dict(rate="1200Kbit")]


@pytest.mark.parametrize("seed", [1, 5])
def test_depth2_matches_depth1_tbf_only_random_load(seed):
    """TBF-only rows that overflow their queue on some ticks and not on
    others: a batch a newer in-flight dispatch shaped from the
    uncorrected bucket is re-shaped exactly, and delivery is depth 1's
    byte for byte (phase 12's TBF class at small size)."""
    g1, p1 = _random_load(TBF_ONLY, 1, seed)
    g2, p2 = _random_load(TBF_ONLY, 2, seed)
    assert g1 == g2
    assert (p1.shaped, p1.dropped) == (p2.shaped, p2.dropped)
    # depth 2 re-shapes the forced rows on top (seed 5 has some)
    assert p2.fallbacks >= p1.fallbacks > 0
    assert seed != 5 or p2.fallbacks > p1.fallbacks
