"""Port parity: kubedtn_tpu_torch.twin (the what-if replica engine)
against kubedtn_tpu.twin, on the CPU.

Both packages fork one numpy snapshot: the 20-node random mesh of
tests/test_twin.py warmed by 20 JAX `sim.run` steps. The JAX sweep draws
from its key schedule; the port's sweep is handed the same draws
(`run_draws`, as tests/test_torch_sim.py hands them to `sim.run`). The
sweep's spec and dt are constants in both, as in `sim.run`, so the
traffic credit is bit for bit.

Every counter, mask, integer and histogram count must match exactly;
float state within the parity tolerances (state rtol 1e-6 / atol 1e-3,
departures rtol 1e-5 / atol 1e-2). The port's own contracts are exact:
replica 0 of an unperturbed sweep IS `sim.run` / `run_routed`, the same
scenarios give the same results at N = 4 and N = 8 and on a replica
mesh of virtual shards, and K1's shared-uniform argument equals the
plain version on repeated uniforms.

No test reads a wall clock.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubedtn_tpu.twin as jtw
from kubedtn_tpu import router as jRT
from kubedtn_tpu import sim as jS
from kubedtn_tpu.api.types import LinkProperties as JLP
from kubedtn_tpu.models import topologies as jT
from kubedtn_tpu.models.traffic import cbr_everywhere
from kubedtn_tpu.ops import routing as jR
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch import router as tRT
from kubedtn_tpu_torch import sim as tS
from kubedtn_tpu_torch import twin as ttw
from kubedtn_tpu_torch.api.types import LinkProperties as TLP
from kubedtn_tpu_torch.models.traffic import TrafficSpec
from kubedtn_tpu_torch.ops import netem as tnetem
from kubedtn_tpu_torch.ops import queues as tq
from kubedtn_tpu_torch.ops.cuda import shaping as tshaping
from kubedtn_tpu_torch.parallel.mesh import (make_replica_mesh,
                                             replica_sharding)
from kubedtn_tpu_torch.twin import engine as teng

from test_torch_netem import STATE_TOL, random_state_np, torch_state
from test_torch_sim import run_draws

STEPS = 30
DT_US = 1000.0
K_SLOTS = 4
N_NODES = 20
SEED = 11


def scenarios(pkg):
    """tests/test_twin.py's six scenarios, in `pkg`'s vocabulary."""
    tw, LP = (jtw, JLP) if pkg == "jax" else (ttw, TLP)
    P, S = tw.Perturbation, tw.Scenario
    return [
        S("baseline"),
        S("degrade-lat", (P("degrade", uid=1,
                            props=LP(latency="50ms")),)),
        S("degrade-loss", (P("degrade", uid=3,
                             props=LP(latency="2ms", loss="30")),)),
        S("fail", (P("fail", uid=2),)),
        S("blackhole", (P("blackhole", node=0),)),
        S("halve-load", (P("scale", factor=0.5),)),
    ]


@pytest.fixture(scope="module")
def base():
    """(JAX snapshot, port snapshot, JAX spec, port spec, edge list,
    row count) of the warmed random mesh."""
    el = jT.random_mesh(N_NODES, 40, seed=3,
                        props=JLP(latency="2ms", jitter="1ms", loss="1"))
    state, rows = jT.load_edge_list_into_state(el)
    spec_j = cbr_everywhere(state.capacity, len(rows), rate_bps=2e6,
                            pkt_bytes=400.0)
    sim = jS.init_sim(state, q=16)
    sim = jS.run(sim, spec_j, steps=20, dt_us=DT_US, k_slots=K_SLOTS,
                 seed=7)
    snap_j = jtw.snapshot_from_sim(sim, n_nodes=N_NODES)
    sim_t = convert.sim_from_numpy(convert.tree_to_numpy(sim), device="cpu")
    snap_t = ttw.snapshot_from_sim(sim_t, n_nodes=N_NODES)
    spec_t = TrafficSpec(**{k: torch.as_tensor(v) for k, v in
                            convert.tree_to_numpy(spec_j).items()})
    return snap_j, snap_t, spec_j, spec_t, el, len(rows)


@pytest.fixture(scope="module")
def draws(base):
    snap_j, _snap_t, spec_j, *_ = base
    return run_draws(SEED, STEPS, spec_j, DT_US, K_SLOTS,
                     snap_j.sim.edges.capacity)


@pytest.fixture(scope="module")
def sweeps(base, draws):
    snap_j, snap_t, spec_j, spec_t, *_ = base
    j = jtw.run_sweep(snap_j, scenarios("jax"), steps=STEPS, dt_us=DT_US,
                      spec=spec_j, k_slots=K_SLOTS, seed=SEED,
                      keep_final=True)
    t = ttw.run_sweep(snap_t, scenarios("torch"), steps=STEPS, dt_us=DT_US,
                      spec=spec_t, k_slots=K_SLOTS, seed=SEED,
                      keep_final=True, draws=draws)
    return j, t


def lane_np(batched, i, n):
    """Lane i of the port's batched state as a numpy tree."""
    return convert.tree_to_numpy(teng.replica_lane(batched, i, n))


def jax_lane_np(batched, i):
    return {g: ({k: v[i] for k, v in d.items()} if isinstance(d, dict)
                else d[i])
            for g, d in convert.tree_to_numpy(batched).items()}


def assert_trees_bitwise(want: dict, got: dict, label=""):
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_trees_bitwise(w, g, f"{label}{k}.")
        else:
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), \
                f"{label}{k}"


def assert_sim_lane_close(want: dict, got: dict, label=""):
    """A JAX lane against the port's: integers, flags and counters
    exactly, float state within the parity tolerances."""
    for k, w in want.items():
        g = got[k]
        name = f"{label}{k}"
        if isinstance(w, dict):
            assert_sim_lane_close(w, g, f"{name}.")
        elif ".counters." in name or w.dtype != np.float32 \
                or k == "credit":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **STATE_TOL)


# -- the fork contract --------------------------------------------------

@pytest.mark.parametrize("given", [True, False])
def test_replica0_unperturbed_bit_identical_to_sim_run(base, draws, given):
    """Replica 0 continues the forked SimState exactly as the port's
    unbatched sim.run does — on the JAX draws handed in, and on the
    port's own seeded generator."""
    _snap_j, snap_t, _spec_j, spec_t, *_ = base
    d = draws if given else None
    res = ttw.run_sweep(snap_t, scenarios("torch"), steps=STEPS,
                        dt_us=DT_US, spec=spec_t, k_slots=K_SLOTS,
                        seed=SEED, keep_final=True, draws=d)
    ref = tS.run(snap_t.sim, spec_t, STEPS, DT_US, K_SLOTS, seed=SEED,
                 draws=d)
    assert_trees_bitwise(convert.tree_to_numpy(ref),
                         lane_np(res.final, 0, res.replicas))
    assert res.compile_s == 0.0  # no kernel build on the CPU


def test_sweep_lanes_equal_jax(base, sweeps):
    """Every lane's final state equals JAX's lane: counters, flags and
    integers exactly, floats within the tolerances; replica 0 bit for
    bit (the JAX sweep's replica 0 is its sim.run)."""
    j, t = sweeps
    assert (j.replicas, j.ticks, j.names) == (t.replicas, t.ticks, t.names)
    for i in range(t.replicas):
        assert_sim_lane_close(jax_lane_np(j.final, i),
                              lane_np(t.final, i, t.replicas),
                              f"lane{i}.")
    want, got = jax_lane_np(j.final, 0), lane_np(t.final, 0, t.replicas)
    for g in ("counters", "traffic"):
        assert_trees_bitwise(want[g], got[g], f"{g}.")


def test_sweep_metrics_equal_jax(sweeps):
    """Per-scenario metrics: counts and histogram bins exactly, the
    derived ratios and percentiles to the float tolerances."""
    j, t = sweeps
    for name, mj, mt in zip(j.names, j.metrics, t.metrics):
        assert mj.keys() == mt.keys(), name
        assert mt["latency_hist"] == mj["latency_hist"], name
        for k in ("tx_packets", "delivered_packets", "dropped_loss",
                  "dropped_queue", "dropped_ring", "corrupted"):
            assert mt[k] == mj[k], (name, k)
        for k, v in mj.items():
            if isinstance(v, float):
                np.testing.assert_allclose(mt[k], v, rtol=1e-6,
                                           err_msg=f"{name}.{k}")
            elif k != "latency_hist":
                assert mt[k] == v, (name, k)


def test_padding_replicas_do_not_perturb_results(base, draws, sweeps):
    """N = 6 and N = 8 (two padding lanes), and the first four scenarios
    at N = 4 and N = 8: identical per-scenario results."""
    _snap_j, snap_t, _spec_j, spec_t, *_ = base
    _j, t = sweeps
    kw = dict(steps=STEPS, dt_us=DT_US, spec=spec_t, k_slots=K_SLOTS,
              seed=SEED, draws=draws)
    sc = scenarios("torch")
    e8 = ttw.compile_scenarios(sc, snap_t.sim.edges, pad_replicas_to=8)
    res8 = ttw.run_sweep(snap_t, sc, edits=e8, **kw)
    assert res8.replicas == 8
    assert res8.metrics == t.metrics
    four = ttw.run_sweep(snap_t, sc[:4], **kw)
    four8 = ttw.run_sweep(snap_t, sc[:4], edits=ttw.compile_scenarios(
        sc[:4], snap_t.sim.edges, pad_replicas_to=8), **kw)
    assert four.replicas == 4 and four8.replicas == 8
    assert four.metrics == four8.metrics == t.metrics[:4]


def test_replica_mesh_of_virtual_shards_matches_unsharded(base, draws,
                                                           sweeps):
    """Lanes split over a 4-entry replica mesh (the CPU repeated: four
    blocks, no communication, joined on the host) give the unsharded
    results; the lane count pads to a multiple of 4."""
    _snap_j, snap_t, _spec_j, spec_t, *_ = base
    _j, t = sweeps
    mesh = make_replica_mesh(devices=["cpu"] * 4)
    res = ttw.run_sweep(snap_t, scenarios("torch"), steps=STEPS,
                        dt_us=DT_US, spec=spec_t, k_slots=K_SLOTS,
                        seed=SEED, mesh=mesh, draws=draws)
    assert res.replicas == 8
    assert res.metrics == t.metrics
    assert replica_sharding(mesh, 8) == [
        (torch.device("cpu"), 0, 2), (torch.device("cpu"), 2, 4),
        (torch.device("cpu"), 4, 6), (torch.device("cpu"), 6, 8)]
    with pytest.raises(ValueError, match="split evenly"):
        replica_sharding(mesh, 6)


def test_perturbations_change_the_future_as_in_jax(sweeps):
    """tests/test_twin.py's reading of the six futures holds in the
    port's results, which are JAX's."""
    j, t = sweeps
    for res in (j, t):
        by = dict(zip(res.names, res.metrics))
        base_m = by["baseline"]
        assert by["degrade-lat"]["p99_us"] > base_m["p99_us"]
        assert (by["degrade-loss"]["delivery_ratio"]
                < base_m["delivery_ratio"])
        assert by["fail"]["tx_packets"] < base_m["tx_packets"]
        assert by["blackhole"]["tx_packets"] < by["fail"]["tx_packets"]
        assert (0.4 * base_m["delivered_bytes"]
                < by["halve-load"]["delivered_bytes"]
                < 0.7 * base_m["delivered_bytes"])
        assert (by["halve-load"]["delivered_packets"]
                == base_m["delivered_packets"])


def test_ranking_and_report_text_equal_jax(sweeps):
    """Ranks and the rendered table equal JAX's for the same results
    (the provenance line's wall times are the JAX run's in both)."""
    j, t = sweeps
    assert ([(n, r) for n, _m, r in ttw.rank_results(t)]
            == [(n, r) for n, _m, r in jtw.rank_results(j)])
    prov = dict(run_s=j.run_s, compile_s=j.compile_s,
                replicas_steps_per_s=j.replicas_steps_per_s)
    text = ttw.render_report(dataclasses.replace(t, **prov))
    assert text == jtw.render_report(j)
    ranks = {n: r for n, _m, r in jtw.rank_results(j)}
    assert (ttw.render_report(t, ranks=ranks, title="x").splitlines()[1:]
            == jtw.render_report(j, ranks=ranks,
                                 title="x").splitlines()[1:])


# -- the routed sweep ---------------------------------------------------

@pytest.fixture(scope="module")
def routed(base):
    """Both packages' RouterStates warmed 15 routed steps on the mesh,
    the flow destinations and the 20 steps' draws after the fork."""
    snap_j, _snap_t, spec_j, spec_t, el, n_rows = base
    state = snap_j.sim.edges
    _, nh = jR.recompute_routes(state, N_NODES, max_hops=8)
    rs = jRT.init_router(state, nh, N_NODES, q=16, k_fwd=4)
    rng = np.random.default_rng(5)
    fdst = np.full((state.capacity,), -1, np.int32)
    fdst[:n_rows] = rng.integers(0, N_NODES, n_rows)
    rs = jRT.run_routed(rs, spec_j, jnp.asarray(fdst), steps=15,
                        dt_us=DT_US, k_slots=K_SLOTS, k_fwd=4, seed=3)
    rs_t = convert.router_from_numpy(convert.tree_to_numpy(rs),
                                     device="cpu")
    d = run_draws(9, 20, spec_j, DT_US, K_SLOTS, state.capacity,
                  k_shape=K_SLOTS + 4)
    return rs, rs_t, fdst, d


def test_routed_replica0_bit_identical_to_run_routed(base, routed):
    _snap_j, _snap_t, spec_j, spec_t, *_ = base
    rs_j, rs_t, fdst, d = routed
    snap = ttw.snapshot_from_router(rs_t, n_nodes=N_NODES)
    ref = tRT.run_routed(snap.router, spec_t, fdst, steps=20, dt_us=DT_US,
                         k_slots=K_SLOTS, k_fwd=4, draws=d)
    res = ttw.run_sweep_routed(snap, scenarios("torch")[:3], steps=20,
                               dt_us=DT_US, spec=spec_t, flow_dst=fdst,
                               k_slots=K_SLOTS, k_fwd=4, keep_final=True,
                               draws=d)
    assert_trees_bitwise(convert.tree_to_numpy(ref),
                         lane_np(res.final, 0, res.replicas))
    assert res.metrics[0]["node_rx_packets"] > 0
    # against JAX's routed sweep: the same counts per scenario (JAX's
    # routed programs trace dt and spec: the credit drifts by an ulp,
    # tests/test_torch_router.py, so floats stay within the tolerances)
    jres = jtw.run_sweep_routed(
        jtw.snapshot_from_router(rs_j, n_nodes=N_NODES),
        scenarios("jax")[:3], steps=20, dt_us=DT_US, spec=spec_j,
        flow_dst=jnp.asarray(fdst), k_slots=K_SLOTS, k_fwd=4, seed=9)
    for mj, mt in zip(jres.metrics, res.metrics):
        for k in ("tx_packets", "delivered_packets", "dropped_loss",
                  "dropped_queue", "dropped_ring", "node_rx_packets",
                  "fwd_dropped", "no_route_dropped"):
            assert mt[k] == mj[k], k
        np.testing.assert_allclose(mt["node_rx_bytes"],
                                   mj["node_rx_bytes"], rtol=1e-6)


@pytest.mark.parametrize("table", ["single", "ecmp"])
def test_routed_lanes_forward_within_their_replica(base, routed, table):
    """A perturbed lane of the routed sweep equals a one-replica sweep of
    the same scenario: packets forward onto their own replica's rows,
    on a single-path table and on ECMP groups (the hash reads the
    ingress row within its replica); replica 0 == run_routed."""
    from kubedtn_tpu_torch.ops import routing as tR

    _snap_j, _snap_t, _spec_j, spec_t, *_ = base
    _rs_j, rs_t, fdst, d = routed
    if table == "ecmp":
        _, groups = tR.recompute_routes_ecmp(rs_t.sim.edges, N_NODES, 3, 8)
        rs_t = dataclasses.replace(rs_t, next_edge=groups)
    snap = ttw.snapshot_from_router(rs_t, n_nodes=N_NODES)
    sc = scenarios("torch")[:5]
    kw = dict(steps=20, dt_us=DT_US, spec=spec_t, flow_dst=fdst,
              k_slots=K_SLOTS, k_fwd=4, keep_final=True, draws=d)
    res = ttw.run_sweep_routed(snap, sc, **kw)
    ref = tRT.run_routed(rs_t, spec_t, fdst, steps=20, dt_us=DT_US,
                         k_slots=K_SLOTS, k_fwd=4, draws=d)
    assert_trees_bitwise(convert.tree_to_numpy(ref),
                         lane_np(res.final, 0, res.replicas))
    for i in (1, 3, 4):
        one = ttw.run_sweep_routed(snap, [sc[i]], **kw)
        assert_trees_bitwise(lane_np(one.final, 0, 1),
                             lane_np(res.final, i, res.replicas))
        assert one.metrics[0] == res.metrics[i]


def test_routed_rejects_traffic_scale(base, routed):
    _snap_j, _snap_t, _spec_j, spec_t, *_ = base
    _rs_j, rs_t, fdst, _d = routed
    snap = ttw.snapshot_from_router(rs_t, n_nodes=N_NODES)
    with pytest.raises(ValueError, match="traffic scale"):
        ttw.run_sweep_routed(
            snap, [ttw.Scenario("s", (ttw.Perturbation("scale",
                                                        factor=2.0),))],
            steps=5, dt_us=DT_US, spec=spec_t, flow_dst=fdst)
    with pytest.raises(ValueError, match="no RouterState"):
        ttw.run_sweep_routed(ttw.snapshot_from_sim(rs_t.sim), [],
                             steps=5, dt_us=DT_US, spec=spec_t,
                             flow_dst=fdst)


# -- the spec's errors, as JAX raises them ------------------------------

SPEC_ERRORS = [
    (("melt",), dict(uid=1), "unknown perturbation"),
    (("fail",), {}, "needs a link uid"),
    (("degrade",), dict(uid=1), "needs LinkProperties"),
    (("blackhole",), {}, "needs a node"),
]


@pytest.mark.parametrize("args,kw,match", SPEC_ERRORS)
def test_spec_validation_like_jax(args, kw, match):
    errs = []
    for tw in (jtw, ttw):
        with pytest.raises(ValueError, match=match) as e:
            tw.Perturbation(*args, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("pert,match", [
    (dict(kind="fail", uid=999_999), "no active rows"),
    (dict(kind="blackhole", node="ghost"), "not found"),
    (dict(kind="blackhole", node=999), "touches no active rows"),
    (dict(kind="blackhole", node="left_or_right"), "ambiguous"),
])
def test_compile_errors_like_jax(base, pert, match):
    snap_j, snap_t, *_ = base
    pod_ids = {"default/left": 0, "default/right": 1,
               "a/left_or_right": 2, "b/left_or_right": 3}
    errs = []
    for tw, snap in ((jtw, snap_j), (ttw, snap_t)):
        sc = [tw.Scenario("x", (tw.Perturbation(**pert),))]
        with pytest.raises(ValueError, match=match) as e:
            tw.compile_scenarios(sc, snap.sim.edges, pod_ids=pod_ids)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_blackhole_by_name_compiles_like_jax(base):
    snap_j, snap_t, *_ = base
    pod_ids = {"default/left": 0, "default/right": 1}
    out = []
    for tw, snap in ((jtw, snap_j), (ttw, snap_t)):
        sc = [tw.Scenario("bh", (tw.Perturbation("blackhole",
                                                 node="left"),)),
              tw.Scenario("bh2", (tw.Perturbation("blackhole",
                                                  node="1"),)),
              tw.Scenario("deg", (tw.Perturbation(
                  "degrade", uid=3, src_node=None,
                  props=(JLP if tw is jtw else TLP)(latency="9ms")),))]
        out.append(tw.compile_scenarios(sc, snap.sim.edges, pod_ids=pod_ids,
                                        pad_replicas_to=4))
    for f in dataclasses.fields(out[0]):
        np.testing.assert_array_equal(getattr(out[1], f.name),
                                      getattr(out[0], f.name),
                                      err_msg=f.name)
    assert out[1].dvalid[0].any() and out[1].n_replicas == 4


def test_duplicate_scenario_names_refused(base):
    _snap_j, snap_t, _spec_j, spec_t, *_ = base
    with pytest.raises(ValueError, match="unique"):
        ttw.run_sweep(snap_t, [ttw.Scenario("a"), ttw.Scenario("a")],
                      steps=1, dt_us=DT_US, spec=spec_t)


# -- K1's shared uniforms through the plain version ----------------------

@pytest.mark.parametrize("n_rep", [1, 3])
def test_k1_shared_uniform_rows_equal_repeated_uniforms(n_rep):
    """shape_step_flags with u_rows = E over N x E rows reads row r's
    uniforms at r % E: the same as the plain step on the uniforms
    repeated N times. With N = 1 it is the one-state step."""
    E = 96
    d = random_state_np(E * n_rep, seed=4 + n_rep)
    rng = np.random.default_rng(n_rep)
    u = torch.as_tensor(rng.random((E, tnetem.NU), dtype=np.float32))
    sizes = torch.as_tensor(rng.uniform(64, 1500, E * n_rep)
                            .astype(np.float32))
    have = torch.as_tensor(rng.random(E * n_rep) < 0.8)
    t_arr = torch.as_tensor(rng.uniform(0, 900, E * n_rep)
                            .astype(np.float32))
    s1, dep1, fl1 = tshaping.shape_step_flags(
        torch_state(d), sizes, have, t_arr, u, donate=False, u_rows=E)
    s2, res2 = tnetem._shape_step_from_u(torch_state(d), sizes, have,
                                          t_arr, u.repeat(n_rep, 1))
    assert dep1.numpy().tobytes() == res2.depart_us.numpy().tobytes()
    np.testing.assert_array_equal(fl1.numpy(),
                                  tshaping.pack_flags(res2).numpy())
    for f in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        assert (getattr(s1, f).numpy().tobytes()
                == getattr(s2, f).numpy().tobytes()), f


def test_k1_uniform_rows_must_divide_the_state():
    d = random_state_np(64, seed=2)
    u = torch.zeros((24, tnetem.NU))
    z = torch.zeros(64)
    with pytest.raises(ValueError, match="divisor"):
        tshaping.shape_step_flags(torch_state(d), z, z > 0, z, u,
                                  donate=False, u_rows=24)
    with pytest.raises(ValueError, match="expected"):
        tshaping.shape_step_flags(torch_state(d), z, z > 0, z,
                                  torch.zeros((16, tnetem.NU)),
                                  donate=False, u_rows=32)


def test_shape_packets_shared_uniforms_equal_plain():
    """queues.shape_packets on N x E rows with [K, E, NU] uniforms ==
    shape_packets_plain with the same uniforms (which repeats them)."""
    E, n, K = 64, 4, 3
    d = random_state_np(E * n, seed=9)
    rng = np.random.default_rng(9)
    u = torch.as_tensor(rng.random((K, E, tnetem.NU), dtype=np.float32))
    sizes = torch.as_tensor(rng.uniform(64, 1500, (E * n, K))
                            .astype(np.float32))
    valid = torch.as_tensor(rng.random((E * n, K)) < 0.7)
    t_arr = torch.as_tensor(np.sort(rng.uniform(0, 900, (E * n, K)), axis=1)
                            .astype(np.float32))
    sa, ra = tq.shape_packets(torch_state(d), sizes, valid, t_arr, u=u)
    sb, rb = tq.shape_packets_plain(torch_state(d), sizes, valid, t_arr,
                                    u=u.repeat(1, n, 1))
    for f in dataclasses.fields(ra):
        np.testing.assert_array_equal(getattr(ra, f.name).numpy(),
                                      getattr(rb, f.name).numpy(),
                                      err_msg=f.name)
    np.testing.assert_array_equal(sa.tokens.numpy(), sb.tokens.numpy())
    with pytest.raises(ValueError, match="E_u dividing"):
        tq.shape_packets(torch_state(d), sizes, valid, t_arr,
                         u=torch.zeros((K, 48, tnetem.NU)))
