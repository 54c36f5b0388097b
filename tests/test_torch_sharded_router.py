"""The port's sharded router (kubedtn_tpu_torch/parallel/router.py) on the
CPU: against the JAX package's `make_sharded_router_step` on the forced
8-device CPU mesh (tests/conftest.py), and against the port's own
unsharded router, bit for bit, on 1, 2, 4 and 8 virtual CPU shards.

The JAX step folds the shard index into each step's key, so shard s
draws its traffic and shaping uniforms on its own from
`fold_in(key(i), s)`; the port is handed exactly those, rebuilt with
tests/test_torch_sim.py's `jax_step_draws` over shard s's rows. The
state leaves follow tests/test_torch_router.py's tolerances: counters,
masks and integers exact, float state within rtol 1e-6 / atol 1e-3, the
traffic credit within the drift of a traced step (JAX traces spec and
dt). Fed the unsharded run's draws sliced per shard, the port's sharded
router equals its unsharded router bit for bit, pending lanes and all,
since every sort is stable and the all-to-all keeps shard order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_sharded_router as jcase
from kubedtn_tpu import router as jRT
from kubedtn_tpu.api.types import LinkProperties
from kubedtn_tpu.models import topologies as jT
from kubedtn_tpu.models import traffic as jtr
from kubedtn_tpu.ops import routing as jR
from kubedtn_tpu.parallel import router as jpr
from kubedtn_tpu.parallel.mesh import make_mesh as jmake_mesh
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch import router as tRT
from kubedtn_tpu_torch import sim as tsim
from kubedtn_tpu_torch.models import traffic as ttr
from kubedtn_tpu_torch.ops import queues as tq
from kubedtn_tpu_torch.parallel import router as tpr
from kubedtn_tpu_torch.parallel.mesh import make_mesh

from test_torch_router import ROUTER_LEAVES, assert_routers_close
from test_torch_sim import jax_step_draws
from test_torch_traffic import torch_spec

K_SLOTS, K_FWD, DT_US = 2, 8, 2000.0


def to_port(jrs, spec_j, flow_dst):
    """The JAX RouterState, spec and flows as the port's, on the CPU."""
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs),
                                    device="cpu")
    return trs, torch_spec(convert.tree_to_numpy(spec_j)), \
        np.asarray(flow_dst)


def shard_spec(spec_j, lo, hi):
    return jtr.TrafficSpec(*(x[lo:hi] for x in dataclasses.astuple(spec_j)))


def jax_shard_draws(i, spec_j, S, E, k_slots=K_SLOTS, k_fwd=K_FWD,
                    dt_us=DT_US):
    """Step i's StepDraws per shard, as the JAX sharded step draws them
    under key(i) (router.py:114 folds the shard index in)."""
    E_loc = E // S
    return [jax_step_draws(jax.random.fold_in(jax.random.key(i), s),
                           shard_spec(spec_j, s * E_loc, (s + 1) * E_loc),
                           dt_us, k_slots, E_loc, k_shape=k_slots + k_fwd)
            for s in range(S)]


def run_port_sharded(trs, spec, flow_dst, steps, S, n_nodes, spec_j,
                     budget=None, dt_us=DT_US, k_slots=K_SLOTS):
    mesh = make_mesh(["cpu"] * S)
    step = tpr.make_sharded_router_step(mesh, n_nodes, k_slots=k_slots,
                                        k_fwd=K_FWD, budget=budget)
    shards = tpr.shard_router_state(trs, mesh)
    E = trs.sim.edges.capacity
    for i in range(steps):
        shards = step(shards, spec, flow_dst, None, dt_us,
                      draws=jax_shard_draws(i, spec_j, S, E, k_slots,
                                            dt_us=dt_us))
    return tpr.gather_router_state(shards)


def run_jax_sharded(jrs, spec_j, flow_dst, steps, n_nodes, budget=None,
                    dt_us=DT_US, k_slots=K_SLOTS):
    step = jpr.make_sharded_router_step(jmake_mesh(8), n_nodes,
                                        k_slots=k_slots, k_fwd=K_FWD,
                                        budget=budget)
    rs = jpr.shard_router_state(jrs, jmake_mesh(8))
    for i in range(steps):
        rs = step(rs, spec_j, flow_dst, jax.random.key(i), dt_us)
    return rs


def both_sharded(jrs, spec_j, flow_dst, steps, n_nodes, budget=None):
    """The JAX sharded run and the port's on the same per-shard draws;
    the JAX state is donated, so the port's inputs are taken first."""
    trs, spec, fd = to_port(jrs, spec_j, flow_dst)
    t = run_port_sharded(trs, spec, fd, steps, 8, n_nodes, spec_j, budget)
    j = run_jax_sharded(jrs, spec_j, flow_dst, steps, n_nodes, budget)
    assert_routers_close(j, t, steps)
    return j, t


def test_sharded_matches_single_device_like_jax(devices8):
    """tests/test_sharded_router.py's chain, every hop on another
    shard: the port == JAX's sharded router, and it reaches the end."""
    n_nodes = 5
    jrs, spec_j, flow_dst = jcase.build(n_nodes)
    _, t = both_sharded(jrs, spec_j, flow_dst, 12, n_nodes)
    assert float(t.node_rx_packets[n_nodes - 1]) > 0
    assert float(t.fwd_dropped) == 0 and float(t.no_route_dropped) == 0


def test_counters_match_jax(devices8):
    n_nodes = 4
    jrs, spec_j, flow_dst = jcase.build(n_nodes)
    j, t = both_sharded(jrs, spec_j, flow_dst, 8, n_nodes)
    np.testing.assert_array_equal(t.sim.counters.tx_packets.numpy(),
                                  np.asarray(j.sim.counters.tx_packets))
    assert float(t.sim.counters.rx_packets.sum()) > 0


def test_exchange_budget_overflow_is_counted_like_jax(devices8):
    n_nodes = 3
    jrs, _, flow_dst = jcase.build(n_nodes)
    spec_j = jcase.cbr_on_rows([0], rate_bps=64e6)
    _, t = both_sharded(jrs, spec_j, flow_dst, 10, n_nodes, budget=1)
    assert float(t.fwd_dropped) > 0


def test_no_route_counted_like_jax(devices8):
    n_nodes = 4
    jrs, spec_j, flow_dst = jcase.build(n_nodes)
    state, rows = jcase.chain_state(n_nodes)
    fd = np.asarray(flow_dst).copy()
    fd[rows[0]] = n_nodes - 1
    state2 = jes_delete(state, rows[-1])
    _, nh = jR.recompute_routes(state2, n_nodes, max_hops=8)
    jrs = dataclasses.replace(jrs, next_edge=nh,
                              sim=dataclasses.replace(jrs.sim, edges=state2))
    _, t = both_sharded(jrs, spec_j, jnp.asarray(fd), 10, n_nodes)
    assert float(t.no_route_dropped) > 0
    assert float(t.node_rx_packets[n_nodes - 1]) == 0


def jes_delete(state, row):
    from kubedtn_tpu.ops import edge_state as jes

    return jes.delete_links(state, jnp.asarray([row]), jnp.asarray([True]))


LOSSY = LinkProperties(latency="2ms", jitter="300us", loss="2",
                       duplicate="3", corrupt_prob="5", rate="50Mbit")


def fat_tree_case(seed: int, capacity: int = 128):
    """The k=4 fat-tree (20 switches, 64 rows in `capacity`) with lossy,
    jittery links; every row sources CBR bound for a random other
    switch. Returns (JAX RouterState, spec, flow_dst, n_nodes)."""
    el = jT.fat_tree(4, LOSSY)
    state, rows = jT.load_edge_list_into_state(el, capacity=capacity)
    n = el.n_nodes
    _, nh = jR.recompute_routes(state, n, max_hops=8)
    jrs = jRT.init_router(state, nh, n, q=16, k_fwd=K_FWD)
    rng = np.random.default_rng(seed)
    src = el.directed()[0]
    flow = np.full(capacity, -1, np.int32)
    flow[:len(src)] = (src + rng.integers(1, n, len(src))) % n
    mode = np.where(np.arange(capacity) < len(src), jtr.MODE_CBR,
                    jtr.MODE_OFF).astype(np.int32)
    z = np.zeros(capacity, np.float32)
    spec_j = jtr.TrafficSpec(
        mode=jnp.asarray(mode),
        rate_bps=jnp.asarray(np.where(mode == 1, 12e6, 0).astype(np.float32)),
        pkt_bytes=jnp.full((capacity,), 1500.0, jnp.float32),
        on_us=jnp.asarray(z), off_us=jnp.asarray(z))
    return jrs, spec_j, jnp.asarray(flow), n


@pytest.mark.parametrize("seed", [0, 1])
def test_lossy_jittery_fat_tree_matches_jax(devices8, seed):
    jrs, spec_j, flow_dst, n = fat_tree_case(seed)
    j, t = both_sharded(jrs, spec_j, flow_dst, 20, n)
    c = t.sim.counters
    for name in ("dropped_loss", "duplicated", "rx_corrupted"):
        assert float(getattr(c, name).sum()) > 0, name
    assert float(t.node_rx_packets.sum()) > 0
    np.testing.assert_array_equal(t.node_rx_bytes.numpy(),
                                  np.asarray(j.node_rx_bytes))


def same_bits(a, b, name=""):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_bits(getattr(a, f.name), getattr(b, f.name),
                      f"{name}.{f.name}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, name
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), name


def unsharded_draws(spec, state, steps, seed, k_slots=4):
    gen = torch.Generator().manual_seed(seed)
    dt = tsim.as_dt(1000.0, "cpu")
    return [tsim.StepDraws(
        traffic=ttr.draw(spec, dt, k_slots, gen),
        shape_u=tq.draw_shape_uniforms(state, k_slots + K_FWD, gen))
        for _ in range(steps)]


@pytest.mark.parametrize("shape_fn", [tq.shape_packets,
                                      tq.shape_packets_plain])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_router_equals_unsharded_bitwise(S, shape_fn):
    """The port's sharded router fed the unsharded run's draws, sliced
    per shard, == its unsharded run_routed, every leaf bit for bit
    (pending lanes in order too), at a budget no step overflows."""
    jrs, spec_j, flow_dst, n = fat_tree_case(3)
    trs, spec, fd = to_port(jrs, spec_j, flow_dst)
    steps = 15
    draws = unsharded_draws(spec, trs.sim.edges, steps, seed=S)
    want = tRT.run_routed(trs, spec, fd, steps, 1000.0, 4, K_FWD,
                          draws=draws, shape_fn=shape_fn)
    mesh = make_mesh(["cpu"] * S)
    step = tpr.make_sharded_router_step(mesh, n, k_slots=4, k_fwd=K_FWD,
                                        budget=128 * 16)
    shards = tpr.shard_router_state(trs, mesh)
    for i in range(steps):
        shards = step(shards, spec, fd, None, 1000.0,
                      draws=tpr.shard_draws(draws[i], mesh),
                      shape_fn=shape_fn)
    got = tpr.gather_router_state(shards)
    same_bits(got, want, "router")
    assert float(got.node_rx_packets.sum()) > 0
    assert int((got.pend_dst >= 0).sum()) > 0
    # the replicated leaves: one tensor per device, shared by its shards
    for name in ("next_edge", "node_rx_packets", "fwd_dropped"):
        assert all(getattr(rs, name) is getattr(shards[0], name)
                   for rs in shards)
    assert all(rs.sim.clock_us is shards[0].sim.clock_us for rs in shards)


def test_sharded_router_from_generators_repeats_and_conserves():
    """Without draws each shard draws from its own generator (seed *
    65536 + s): a rerun gives the same bits and every edge's books
    close."""
    jrs, spec_j, flow_dst, n = fat_tree_case(4)
    trs, spec, fd = to_port(jrs, spec_j, flow_dst)
    mesh = make_mesh(["cpu"] * 4)
    step = tpr.make_sharded_router_step(mesh, n, k_slots=4, k_fwd=K_FWD)

    def run(seed):
        gens = tpr.shard_generators(mesh, seed)
        shards = tpr.shard_router_state(trs, mesh)
        for _ in range(10):
            shards = step(shards, spec, fd, gens, 1000.0)
        return tpr.gather_router_state(shards)

    a = run(7)
    same_bits(a, run(7))
    assert not bool(tsim.conservation_residual(a.sim).any())
    assert float(a.node_rx_packets.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_by_shard_matches_jax_with_overflow(seed):
    rng = np.random.default_rng(seed)
    M, S, budget = 300, 4, 16
    shard_of = rng.integers(0, S, M).astype(np.int32)
    live = rng.random(M) < 0.8
    shard_of[0:60] = 2                # one destination over its budget
    live[0:60] = True
    lrow = rng.integers(0, 1000, M).astype(np.int32)
    size = rng.choice([64.0, 1500.0], M).astype(np.float32)
    fdst = rng.integers(0, 500, M).astype(np.int32)
    corr = rng.random(M) < 0.1
    args = (shard_of, lrow, size, fdst, corr, live)
    jbuf, jdrop = jpr._bucket_by_shard(*(jnp.asarray(x) for x in args), S,
                                       budget)
    tbuf, tdrop = tpr._bucket_by_shard(*(torch.as_tensor(x) for x in args),
                                       S, budget)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    assert float(tdrop) == float(jdrop) > 0


def test_all_to_all_keeps_shard_order():
    S, B = 4, 3
    sends = [torch.arange(S * B * 4, dtype=torch.float32).view(S, B, 4)
             + 1000 * s for s in range(S)]
    recv = tpr.all_to_all(sends, make_mesh(["cpu"] * S))
    for d in range(S):
        want = torch.cat([sends[s][d] for s in range(S)])
        assert torch.equal(recv[d], want)


def test_ecmp_tables_are_refused():
    jrs, _, _, n = fat_tree_case(0)
    _, nh = jR.recompute_routes_ecmp(jrs.sim.edges, n, k_paths=2,
                                     max_hops=8)
    trs = convert.router_from_numpy(
        convert.tree_to_numpy(dataclasses.replace(jrs, next_edge=nh)),
        device="cpu")
    with pytest.raises(AssertionError, match="single-path"):
        tpr.shard_router_state(trs, make_mesh(["cpu"] * 8))


def test_shard_and_gather_round_trip_and_leaf_split():
    jrs, _, _, _ = fat_tree_case(0)
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs),
                                    device="cpu")
    shards = tpr.shard_router_state(trs, make_mesh(["cpu"] * 8))
    assert all(rs.sim.edges.capacity == 16 and rs.pend_size.shape[0] == 16
               for rs in shards)
    same_bits(tpr.gather_router_state(shards), trs)
    assert set(ROUTER_LEAVES) == {f.name for f in dataclasses.fields(
        tRT.RouterState)} - {"sim"}
    with pytest.raises(ValueError, match="not divisible"):
        tpr.shard_router_state(trs, make_mesh(["cpu"] * 3))


def test_chip_smoke_phase_22_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 22 on the CPU at an 8 x 20 Clos (640 rows
    in 1024) with small rung arguments: every check of (a)-(e) runs
    (launch counts pass vacuously without a card); the batch, the
    router's budget and (c)'s overflow budget scaled to the fabric."""
    import chip_smoke as cs
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties as TLP
    from kubedtn_tpu_torch.models.topologies import (
        clos, load_edge_list_into_state, random_link_props)
    from kubedtn_tpu_torch.ops import edge_state as tes

    monkeypatch.setattr(cs, "SH_BATCH", 100)
    monkeypatch.setattr(cs, "SR_BUDGET", 1 << 10)
    monkeypatch.setattr(cs, "SR_OVERFLOW_BUDGET", 2)
    dev = torch.device("cpu")
    el = clos(8, 20, 0, props=TLP(latency="10ms", rate="10Gbit"),
              links_per_pair=2)
    state, _ = load_edge_list_into_state(el, device=dev)
    n = 2 * el.n_links
    tes.update_links(state, np.arange(n, dtype=np.int32),
                     random_link_props(n, 1), np.ones(n, bool),
                     contiguous=True)
    routed = entry.build_routed(
        el, state, np.arange(8, el.n_nodes), seed=31,
        rate_bps=cs.ROUTED_RATE_BPS, q=cs.SIM_Q, k_fwd=cs.ROUTED_K_FWD,
        max_hops=cs.ROUTE_HOPS)[:3]
    m, k1 = cs.run_scale_phase(el, state, dev, "cpu", routed=routed,
                               rung_kw={
        "routes_10k": dict(n_nodes=200, n_links=600, dst_chunk=40),
        "chaos_flaps": dict(n_nodes=60, n_links=180, events=2,
                            steps_per_event=10),
        "reconverge_10k": dict(pods=3, leaves_per_pod=8)})
    assert k1 == {"sharded_step": 0, "sharded_router": 0, "rungs": 0}
    assert set(m["a"]) == set(cs.SH_SHARDS)
    assert m["b"]["exchanged_per_step"] > 0
    assert m["b"]["overflow"]["fwd_dropped"] > 0
    assert m["d"]["delivered"] > 0
    assert m["e"]["reconverge_10k"]["matches_full_recompute"] is True
