"""Trap tests of the port's live plane against the JAX package's:
what the port's IN-PLACE edge state could get wrong while a dispatch is
in flight (depth 2) — an UpdateLinks scatter and a compact() — on the
deterministic links of test_torch_plane.py, where per-wire egress,
release ticks, counters and the realized state must equal JAX's. Also
pins a fault of the JAX package found here (ROADMAP §3). No test reads a
wall clock.
"""

import numpy as np
import pytest

from test_torch_plane import (DET_COUNTS, DET_PROPS, assert_same_run,
                              build, drive, update_hook)


@pytest.mark.parametrize("props", [dict(latency="3ms"),
                                   dict(rate="2Mbit"),
                                   dict(latency="1ms",
                                        latency_corr="50")],
                         ids=["to-indep", "to-tbf", "to-seq"])
def test_update_links_during_inflight_dispatch_matches_jax(props):
    """At depth 2 a dispatch is always in flight when the update lands;
    the port's in-place scatter must give what JAX's snapshot gives."""
    runs = {}
    for pkg in ("jax", "torch"):
        sc = build(pkg, DET_PROPS, depth=2)
        got = drive(sc, feed_ticks=5, drain_ticks=25,
                    hook=update_hook(3, 1, props))
        runs[pkg] = (got, sc.plane, sc.engine)
    assert_same_run(runs["jax"], runs["torch"])


def compact_hook(sc, t):
    """Before tick 2 delete pair 0's links; before tick 3 compact()."""
    if t == 2:
        topo = sc.engine.get_pod("a0")
        sc.engine.del_links(topo, topo.spec.links)
    if t == 3:
        sc.engine.compact()


# DET_PROPS without the overflowing TBF link (see the next two tests)
NO_FALLBACK = DET_PROPS[:1] + (dict(rate="50Mbit"),) + DET_PROPS[2:]


def test_compact_during_inflight_dispatch_matches_jax():
    """Delete one pair's links, then compact() (rows renumbered) while a
    dispatch is in flight: delivery, counters (remapped with the rows)
    and the realized state equal JAX's."""
    runs = {}
    for pkg in ("jax", "torch"):
        sc = build(pkg, NO_FALLBACK, depth=2)
        got = drive(sc, feed_ticks=5, drain_ticks=25, hook=compact_hook)
        runs[pkg] = (got, sc.plane, sc.engine)
        assert sc.engine.row_of("default/a1", 2) == 0  # renumbered
    assert_same_run(runs["jax"], runs["torch"])


def test_compact_with_inflight_tbf_fallback():
    """The same with the TBF fallback due in the in-flight job (where the
    JAX package fails, see the next test): the port's job carries its own
    gathered pre-dispatch rows, so the re-shape at the flush compact()
    triggers reads nothing of the repacked state. Every frame fed is
    shaped or dropped, the books close per edge, the fallback ran. (The
    in-flight job's write-back is void after a compact, as in the JAX
    plane, so the delivery is not depth 1's.)"""
    sc = build("torch", DET_PROPS, depth=2)
    got = drive(sc, feed_ticks=5, drain_ticks=25, hook=compact_hook)
    p = sc.plane
    # pair 0's link is gone from tick 2: its later frames stay queued
    assert len(sc.win[0].ingress) == 3 * DET_COUNTS[0]
    fed = 5 * sum(DET_COUNTS) - 3 * DET_COUNTS[0]
    assert p.shaped + p.dropped == fed
    assert sum(len(w) for w in got) == p.shaped
    c = p.counters
    np.testing.assert_array_equal(
        c.rx_packets + c.dropped_loss + c.dropped_queue, c.tx_packets)
    assert p.fallbacks > 0 and c.dropped_queue.sum() > 0


def test_jax_compact_during_inflight_fallback_fault():
    """Pins a fault of the JAX package (ROADMAP §3): its compact()
    donates the edge state to compact_state, while an in-flight job
    still holds that state for its TBF fallback re-shape; the flush that
    compact() triggers then reads a deleted buffer. When the JAX package
    is fixed this test fails and the ROADMAP entry goes."""
    sc = build("jax", DET_PROPS, depth=2)
    with pytest.raises(ValueError, match="deleted or donated"):
        drive(sc, feed_ticks=5, drain_ticks=25, hook=compact_hook)


def test_jax_depth2_parts_from_depth1_on_lossy_tbf_fault():
    """Pins a fault of the JAX package (ROADMAP §3): its depth-1 ≡
    depth-2 contract fails on TBF rows WITH loss whose batches overflow
    the 50 ms queue on some ticks only. At depth 2 the batch a newer
    in-flight dispatch shaped from the uncorrected bucket is re-shaped by
    the exact scan under fold_in(sub, 3); at depth 1 the same batch is
    shaped by the max-plus core under fold_in(sub, 2): other loss draws.
    The port keeps the JAX semantics (TBF-only rows hold the contract,
    test_torch_plane_contracts.py). When the JAX package is fixed this
    test fails and the ROADMAP entry goes."""
    def run(depth):
        sc = build("jax", [dict(rate="1Mbit", loss="3")] * 4, depth=depth)
        rng = np.random.default_rng(1)
        got = [[] for _ in sc.wout]
        for t in range(30):
            if t < 16:
                for k, w in enumerate(sc.win):
                    w.ingress.extend(
                        bytes([k, t, j]) + b"z" * int(s) for j, s in
                        enumerate(rng.integers(61, 254, int(
                            rng.integers(1, 65)))))
            sc.plane.tick(now_s=(t + 1) * 0.01)
            for k, w in enumerate(sc.wout):
                got[k].extend(w.egress)
                w.egress.clear()
        return got

    assert run(1) != run(2)
