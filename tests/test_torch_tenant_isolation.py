"""The multi-tenant isolation contract in the port, and the
tenant-scoped twin against the JAX package's, on the CPU.

Within the port, on the drawing TENANT_PROPS of
tests/test_tenant_isolation.py (one tenant per kernel class: jitter and
loss, a TBF rate, correlated loss): each tenant's per-wire delivered
bytes, telemetry window totals over its rows and counter slice in a
COHABITED plane equal, bit for bit, a SOLO plane of its topology alone,
at pipeline depths 1 and 2 and on 2 and 4 virtual CPU shards, with
`t1`'s rows packed into a reserved block in the cohabited plane; and a
same-class aggressor bursting 5 frames a tick beside a victim at 3
leaves the victim's stream as it is alone. The port keys every row's
draws by the link's identity (engine.link_key_id), never by the batch's
composition or padding.

Against JAX, on deterministic links (the two packages' draws differ):
the cohabited plane's per-wire egress at depths 1 and 2. The scoped
fork (`tenant_snapshot`) activates exactly the tenant's rows in both
packages, and a sweep of it on the port, handed JAX's own draws
(`run_draws`, as tests/test_torch_twin.py does), equals JAX's sweep of
JAX's scoped fork: counters and integers exactly, float state within
the Pallas parity tolerances (state rtol 1e-6 / atol 1e-3).

No test reads a wall clock.
"""

import numpy as np
import pytest
import torch

import kubedtn_tpu.twin as jtw
import kubedtn_tpu_torch.twin as ttw
from kubedtn_tpu.twin.query import build_cbr_spec as jbuild_cbr_spec
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch.models.traffic import TrafficSpec

from _torch_tenant_harness import mods, run_schedule, tenant_plane
from test_torch_sim import run_draws
from test_torch_tenancy import DET_TENANT_PROPS
from test_torch_twin import assert_sim_lane_close, jax_lane_np, lane_np

TENANT_PROPS = {
    "t0": dict(latency="2ms", jitter="1ms", loss="10"),
    "t1": dict(rate="2Mbit"),
    "t2": dict(latency="1ms", loss="10", loss_corr="25"),
}
NAMES = sorted(TENANT_PROPS)
TORCH = mods("torch")


def _shard(n):
    return None if n is None else (
        lambda plane: plane.enable_sharding(n_devices=n))


@pytest.fixture(scope="module")
def solo():
    """Each tenant alone, at depth 1 (the reference of every case)."""
    return {ns: run_schedule(TORCH, [ns], TENANT_PROPS, depth=1)
            for ns in NAMES}


@pytest.mark.parametrize("depth,shards", [(1, None), (2, None), (1, 2),
                                          (2, 4)],
                         ids=["d1", "d2", "d1-2shards", "d2-4shards"])
def test_cohabited_equals_solo(solo, depth, shards):
    """Three tenants sharing one plane (t1 packed into a reserved
    block): every tenant's delivered bytes, telemetry totals and counter
    slice equal its solo plane's, bit for bit; the slices sum to the
    plane's counters."""
    co_del, co_tel, co_cnt, plane, reg = run_schedule(
        TORCH, NAMES, TENANT_PROPS, depth=depth, shard=_shard(shards),
        registry_kw={"t1": {"block_edges": 6}})
    lo, hi = reg.get("t1").block
    rows = reg.rows_of("t1")
    assert ((rows >= lo) & (rows < hi)).all()
    for ns in NAMES:
        so_del, so_tel, so_cnt, *_ = solo[ns]
        assert co_del[ns] == so_del[ns], f"tenant {ns} byte stream"
        np.testing.assert_array_equal(co_tel[ns], so_tel[ns])
        assert co_cnt[ns] == so_cnt[ns]
    for key, col in (("tx_packets", plane.counters.tx_packets),
                     ("delivered_packets", plane.counters.rx_packets),
                     ("dropped_loss", plane.counters.dropped_loss)):
        assert sum(co_cnt[ns][key] for ns in NAMES) == float(col.sum())
    assert co_cnt["t0"]["dropped_loss"] > 0   # the draws decided things
    if shards:
        assert plane.shard_summary()["n_shards"] == shards


def test_pad_bucket_crossing_aggressor_keeps_victim_identical():
    """An aggressor in the victim's kernel class at 5 frames a tick
    beside the victim at 3: the victim's stream, telemetry and counters
    equal its solo run at depths 1 and 2."""
    props = {"agg": TENANT_PROPS["t0"], "vic": TENANT_PROPS["t0"]}
    for depth in (1, 2):
        co_del, co_tel, co_cnt, *_ = run_schedule(
            TORCH, ["agg", "vic"], props, depth=depth,
            frames_per_tick={"agg": 5, "vic": 3})
        so_del, so_tel, so_cnt, *_ = run_schedule(
            TORCH, ["vic"], props, depth=depth,
            frames_per_tick={"vic": 3})
        assert co_del["vic"] == so_del["vic"], f"victim bytes d{depth}"
        np.testing.assert_array_equal(co_tel["vic"], so_tel["vic"])
        assert co_cnt["vic"] == so_cnt["vic"]


@pytest.mark.parametrize("depth", [1, 2])
def test_cohabited_egress_equals_jax_on_deterministic_links(depth):
    """The cohabited plane of the DET tenants: every tenant's per-wire
    egress and counter slice equal JAX's at this depth."""
    got = {p: run_schedule(mods(p), sorted(DET_TENANT_PROPS),
                           DET_TENANT_PROPS, depth=depth, ticks=8,
                           frames_per_tick={"t0": 3, "t1": 30, "t2": 5},
                           drain_ticks=80)
           for p in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][2] == got["jax"][2]


# -- the tenant-scoped fork ----------------------------------------------

def test_tenant_snapshot_scopes_edges_like_jax():
    """tenant_snapshot of a live plane activates exactly rows_of(t1), in
    the port as in JAX, and every other column of the fork equals the
    unscoped fork's."""
    got = {}
    for p in ("jax", "torch"):
        plane, reg, _w = tenant_plane(mods(p), NAMES, TENANT_PROPS)
        snap = reg.tenant_snapshot(plane, "t1")
        rows = reg.rows_of("t1")
        active = np.asarray(convert.tree_to_numpy(snap.sim.edges)["active"]
                            if p == "torch" else snap.sim.edges.active)
        assert active[rows].all() and active.sum() == rows.size
        got[p] = (active.tolist(), rows.tolist())
        plane.stop()
    assert got["torch"] == got["jax"]


def test_whatif_tenant_slots_and_refusals():
    """Per-tenant sweep slots are distinct; a WhatIf naming a tenant of
    the registry is served from its scoped fork, an unknown tenant and
    a daemon without a registry refuse it."""
    from kubedtn_tpu_torch.twin.query import _sweep_slots
    from kubedtn_tpu_torch.wire import proto as pb

    plane, reg, _w = tenant_plane(TORCH, NAMES, TENANT_PROPS)
    d = plane.daemon
    assert _sweep_slots(d, "t0") is not _sweep_slots(d, "t1")
    assert _sweep_slots(d, "t0") is _sweep_slots(d, "t0")
    req = dict(ticks=20, dt_us=1000.0, seed=3, include_baseline=True)
    ok = d.WhatIf(pb.WhatIfRequest(tenant="t1", **req), None)
    assert ok.ok, ok.error
    assert ok.results[0].tx_packets > 0
    bad = d.WhatIf(pb.WhatIfRequest(tenant="nope", **req), None)
    assert not bad.ok and "unknown tenant 'nope'" in bad.error
    d.tenancy = None
    none = d.WhatIf(pb.WhatIfRequest(tenant="t1", **req), None)
    assert not none.ok and "unknown tenant" in none.error
    plane.stop()


SWEEP_STEPS = 20
SWEEP_DT_US = 1000.0
SWEEP_K = 4
SWEEP_SEED = 13


def _scenarios(tw, LP):
    P, S = tw.Perturbation, tw.Scenario
    return [S("baseline"),
            S("degrade-t1", (P("degrade", uid=3,
                               props=LP(rate="1Mbit", loss="5")),)),
            S("half-load", (P("scale", factor=0.5),))]


def test_tenant_scoped_sweep_equals_jax_on_its_draws():
    """A 3-scenario sweep of t1's scoped fork of the engine: the forks'
    columns equal; the port's sweep, handed JAX's draws, equals JAX's
    sweep lane by lane (counters exactly, float state within the
    tolerances) and metric by metric; no row outside t1 carries a
    packet."""
    from kubedtn_tpu.api.types import LinkProperties as JLP
    from kubedtn_tpu_torch.api.types import LinkProperties as TLP

    snaps = {}
    for p in ("jax", "torch"):
        plane, reg, _w = tenant_plane(mods(p), NAMES, TENANT_PROPS,
                                      telemetry=False)
        snaps[p] = (reg.tenant_snapshot(plane.engine, "t1"),
                    reg.rows_of("t1"))
        plane.stop()
    sj, rows = snaps["jax"]
    st, _ = snaps["torch"]
    ej = convert.tree_to_numpy(sj.sim.edges)
    et = convert.tree_to_numpy(st.sim.edges)
    for k in ej:
        np.testing.assert_array_equal(et[k], ej[k], err_msg=k)
    spec_j = jbuild_cbr_spec(sj.sim.edges, rate_bps=4e6, pkt_bytes=300.0)
    spec_t = TrafficSpec(**{k: torch.as_tensor(v) for k, v in
                            convert.tree_to_numpy(spec_j).items()})
    E = sj.sim.edges.capacity
    draws = run_draws(SWEEP_SEED, SWEEP_STEPS, spec_j, SWEEP_DT_US,
                      SWEEP_K, E)
    kw = dict(steps=SWEEP_STEPS, dt_us=SWEEP_DT_US, k_slots=SWEEP_K,
              seed=SWEEP_SEED, keep_final=True)
    j = jtw.run_sweep(sj, _scenarios(jtw, JLP), spec=spec_j, **kw)
    t = ttw.run_sweep(st, _scenarios(ttw, TLP), spec=spec_t, draws=draws,
                      **kw)
    assert (j.replicas, j.names) == (t.replicas, t.names)
    outside = np.setdiff1d(np.arange(E), rows)
    for i in range(t.replicas):
        lane_t = lane_np(t.final, i, t.replicas)
        assert_sim_lane_close(jax_lane_np(j.final, i), lane_t, f"lane{i}.")
        assert not lane_t["counters"]["tx_packets"][outside].any()
    for name, mj, mt in zip(j.names, j.metrics, t.metrics):
        for k in ("tx_packets", "delivered_packets", "dropped_loss",
                  "dropped_queue", "latency_hist"):
            assert mt[k] == mj[k], (name, k)
    assert t.metrics[0]["tx_packets"] > 0


# -- a fault of the JAX design, shared by the port (ROADMAP §3) ----------

def _tbf_run(pkg, depth):
    """12 pairs at 2 Mbit TBF-only, 1-64 frames of 64-256 bytes per wire
    and tick for 10 ticks of 10 ms, then 30 idle ticks."""
    from kubedtn_tpu_torch import telemetry as tele

    plane, reg, wires = tenant_plane(mods(pkg), ["t1"], TENANT_PROPS,
                                     depth=depth, pairs=12)
    rng = np.random.default_rng(5)
    t = 100.0
    for k in range(40):
        if k < 10:
            for i, w in enumerate(wires["t1"][0]):
                w.ingress.extend(
                    bytes([i]) + j.to_bytes(4, "big") + b"\x5a" * int(s)
                    for j, s in enumerate(rng.integers(
                        59, 252, int(rng.integers(1, 65)))))
        t += 0.01
        plane.tick(now_s=t)
    plane.flush()
    total, _ = plane.telemetry.window_sum()
    rows = reg.rows_of("t1")
    plane.stop()
    return ([list(w.egress) for w in wires["t1"][1]], total[rows],
            tele.T_LAT_SUM_US)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_depth2_telemetry_latency_sum_parts_on_forced_rows_fault(pkg):
    """Both packages: on TBF rows whose queue overflows, a depth-2 plane
    re-shapes FORCED rows (shaped by a newer in-flight dispatch from the
    uncorrected bucket) and corrects the window ring on the host in
    float64 (runtime._complete: the stale row subtracted, the exact one
    added), where depth 1 accumulates the same frames in the float32
    device fold. Egress and every count column are equal; the
    latency-sum column T_LAT_SUM_US parts in its last bits. Phase 16(c)
    of chip_smoke.py compares that column within the parity tolerance
    for this reason."""
    e1, t1, lat = _tbf_run(pkg, 1)
    e2, t2, _ = _tbf_run(pkg, 2)
    assert e1 == e2
    others = [c for c in range(t1.shape[1]) if c != lat]
    np.testing.assert_array_equal(t1[:, others], t2[:, others])
    assert not np.array_equal(t1[:, lat], t2[:, lat])
    np.testing.assert_allclose(t2[:, lat], t1[:, lat], rtol=1e-6)
