"""Port parity: kubedtn_tpu_torch.router against kubedtn_tpu.router on
the CPU, on the graphs of tests/test_routing.py (the line, the small
Clos, the ECMP diamond).

Both packages start from one numpy RouterState and run on the JAX
package's own draws (router.py:259 splits key(seed) per step, :119 each
step key into the traffic and shaping keys; the shaping key covers
k_slots + k_fwd slots). Every RouterState counter, mask and integer must
match exactly, float state within the parity tolerances. `run_routed`
traces spec and dt, so `traffic.credit` is held within the drift of
tests/test_torch_sim.py (the port equals `sim.run` bit for bit, not
this entry); the packet counts are equal all the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu import router as jRT
from kubedtn_tpu.api.types import LinkProperties
from kubedtn_tpu.models import topologies as jT
from kubedtn_tpu.models import traffic as jtr
from kubedtn_tpu.ops import routing as jR
from kubedtn_tpu_torch import convert, entry
from kubedtn_tpu_torch import router as tRT
from kubedtn_tpu_torch import sim as tsim
from kubedtn_tpu_torch.models import topologies as tT
from kubedtn_tpu_torch.ops import queues as tq

from test_torch_netem import STATE_TOL, jax_state
from test_torch_sim import (CREDIT_DRIFT_PER_STEP, assert_sims_close,
                            run_draws)
from test_torch_traffic import jax_spec, torch_spec

ROUTER_LEAVES = ("next_edge", "pend_size", "pend_dst", "pend_corr",
                 "node_rx_packets", "node_rx_bytes", "fwd_dropped",
                 "no_route_dropped")


def flows_np(capacity, rows, dsts, rate=12e6, pkt=1500.0):
    """(spec numpy dict, flow_dst) with CBR on `rows` bound for `dsts`."""
    mode = np.zeros(capacity, np.int32)
    mode[rows] = jtr.MODE_CBR
    rate_bps = np.zeros(capacity, np.float32)
    rate_bps[rows] = rate
    flow = np.full(capacity, -1, np.int32)
    flow[rows] = dsts
    z = np.zeros(capacity, np.float32)
    return dict(mode=mode, rate_bps=rate_bps,
                pkt_bytes=np.full(capacity, pkt, np.float32), on_us=z,
                off_us=z.copy()), flow


def case(name: str):
    """(edge list, props, spec numpy, flow_dst, ecmp k_paths or None,
    k_fwd)."""
    lossy = LinkProperties(latency="2ms", jitter="300us", loss="2",
                           duplicate="3", corrupt_prob="5", rate="50Mbit")
    if name == "line":
        el = jT.line(3, LinkProperties(latency="10ms"))
        return el, (0,), (2,), None, 8
    if name == "line_lossy_back":
        el = jT.line(4, lossy)
        # both ends send to each other, the middle to an end
        return el, (0, el.n_links + 2, 1), (3, 0, 3), None, 8
    if name == "clos":
        el = jT.clos(2, 4, 0, props=LinkProperties(latency="1ms"))
        return el, (el.n_links + 0,), (2 + 3,), None, 8
    if name == "clos_all_leaves":
        el = jT.clos(2, 4, 0, props=lossy)
        rows = el.n_links + np.arange(el.n_links)       # leaf -> spine
        leaf = el.directed()[0][rows] - 2
        return el, tuple(rows), tuple(2 + (leaf + 1) % 4), None, 8
    if name == "clos_overflow":     # 4 flows squeeze into 2 lanes
        el = jT.clos(1, 4, 0, props=LinkProperties(latency="1ms"))
        rows = el.n_links + np.arange(el.n_links)
        return el, tuple(rows), (1, 1, 1, 2), None, 2
    if name == "diamond_ecmp":
        el = jT._mk(["s1", "s2", "a", "b", "c", "d"],
                    [(0, 2), (1, 2), (2, 3), (2, 4), (3, 5), (4, 5)],
                    LinkProperties(latency="1ms"))
        return el, (0, 1), (5, 5), 4, 8
    if name == "clos_ecmp":
        el = jT.clos(3, 4, 0, props=lossy, links_per_pair=2)
        rows = el.n_links + np.arange(el.n_links)
        leaf = el.directed()[0][rows] - 3
        return el, tuple(rows), tuple(3 + (leaf + 2) % 4), 2, 8
    raise KeyError(name)


CASES = ["line", "line_lossy_back", "clos", "clos_all_leaves",
         "clos_overflow", "diamond_ecmp", "clos_ecmp"]


def both_routers(name, q=16):
    el, rows, dsts, k_paths, k_fwd = case(name)
    state, _ = jT.load_edge_list_into_state(el)
    n = el.n_nodes
    if k_paths is None:
        _, nh = jR.recompute_routes(state, n, max_hops=8)
    else:
        _, nh = jR.recompute_routes_ecmp(state, n, k_paths=k_paths,
                                         max_hops=8)
    jrs = jRT.init_router(state, nh, n, q=q, k_fwd=k_fwd)
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs), device="cpu")
    spec_np, flow = flows_np(state.capacity, list(rows), list(dsts))
    return el, jrs, trs, spec_np, flow, k_fwd


def assert_routers_close(jrs, trs, steps, node_bytes_atol=None):
    """`node_bytes_atol` (f32[n]) is for totals beyond 2^24 only, where
    the port's one rounding a step and the reference's one a packet
    part."""
    assert_sims_close(jrs.sim, trs.sim,
                      credit_atol=steps * CREDIT_DRIFT_PER_STEP)
    for name in ROUTER_LEAVES:
        want = np.asarray(getattr(jrs, name))
        got = getattr(trs, name).numpy()
        assert got.dtype == want.dtype, name
        if name == "pend_size":
            np.testing.assert_allclose(got, want, err_msg=name, **STATE_TOL)
        elif name == "node_rx_bytes" and node_bytes_atol is not None:
            assert (np.abs(got.astype(np.float64) - want)
                    <= node_bytes_atol).all(), (name, got, want)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", CASES)
def test_run_routed_matches_jax(name):
    el, jrs, trs, spec_np, flow, k_fwd = both_routers(name)
    spec_j = jax_spec(spec_np)
    steps, dt, k, seed = 40, 1000.0, 4, 3
    E = jrs.sim.edges.capacity
    jrs = jRT.run_routed(jrs, spec_j, jnp.asarray(flow), steps, dt,
                         k_slots=k, k_fwd=k_fwd, seed=seed)
    draws = run_draws(seed, steps, spec_j, dt, k, E, k_shape=k + k_fwd)
    trs = tRT.run_routed(trs, torch_spec(spec_np), flow, steps, dt,
                         k_slots=k, k_fwd=k_fwd, draws=draws)
    assert_routers_close(jrs, trs, steps)
    # one 1,500-byte packet per ms leaves the port's credit at 0; the
    # traced JAX program adds f32(1500.0001) a step and keeps the rest
    assert not trs.sim.traffic.credit.any()
    assert trs.node_rx_packets.sum() > 0
    assert float(trs.no_route_dropped) == 0
    if name == "line":
        assert trs.node_rx_packets[1] == 0      # transit keeps nothing
        assert abs(float(trs.node_rx_packets[2]) - 20) <= 2
    if name == "clos_overflow":
        assert float(trs.fwd_dropped) > 0
    else:
        assert float(trs.fwd_dropped) == 0
    if name == "diamond_ecmp":  # both arms carry traffic
        tx = trs.sim.counters.tx_packets
        assert tx[2] > 0 and tx[3] > 0


def test_no_route_is_counted_like_jax():
    """A destination cut off mid-run: transit packets find no route."""
    el, jrs, trs, spec_np, flow, k_fwd = both_routers("line")
    d = convert.tree_to_numpy(jrs.sim.edges)
    d["active"] = d["active"].copy()
    d["active"][[1, 1 + el.n_links]] = False
    _, nh = jR.recompute_routes(jax_state(d), el.n_nodes, max_hops=8)
    # the edges stay up in the fabric: the routing table alone is cut
    jrs = dataclasses.replace(jrs, next_edge=nh)
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs), device="cpu")
    spec_j = jax_spec(spec_np)
    steps, dt, k, seed = 30, 1000.0, 4, 1
    jrs = jRT.run_routed(jrs, spec_j, jnp.asarray(flow), steps, dt,
                         k_slots=k, k_fwd=k_fwd, seed=seed)
    draws = run_draws(seed, steps, spec_j, dt, k, jrs.sim.edges.capacity,
                      k_shape=k + k_fwd)
    trs = tRT.run_routed(trs, torch_spec(spec_np), flow, steps, dt,
                         k_slots=k, k_fwd=k_fwd, draws=draws)
    assert_routers_close(jrs, trs, steps)
    assert float(trs.no_route_dropped) > 0
    assert trs.node_rx_packets.sum() == 0


def test_node_rx_bytes_beyond_2_to_24_round_once_a_step():
    """Between 2^24 and 2^25 bytes f32 steps by 2, and an odd packet size
    makes the sums ties: the reference rounds after each packet (up to a
    byte each, and ties to even do not cancel), the port after each
    step's exact per-node sum (up to a byte a step). So the two totals
    part by at most a byte per packet delivered, and the port's stays
    within a byte per step of the exact one. Packet counts stay equal."""
    name, steps, dt, k, seed = "clos_all_leaves", 40, 1000.0, 4, 2
    el, jrs, _, _, _, k_fwd = both_routers(name)
    _, rows, dsts, _, _ = case(name)
    E = jrs.sim.edges.capacity
    spec_np, flow = flows_np(E, list(rows), list(dsts), pkt=1501.0)
    start = np.full(el.n_nodes, 2.0 ** 24 - 3000.0, np.float32)
    jrs = dataclasses.replace(jrs, node_rx_bytes=jnp.asarray(start))
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs),
                                    device="cpu")
    spec_j = jax_spec(spec_np)
    jrs = jRT.run_routed(jrs, spec_j, jnp.asarray(flow), steps, dt,
                         k_slots=k, k_fwd=k_fwd, seed=seed)
    draws = run_draws(seed, steps, spec_j, dt, k, E, k_shape=k + k_fwd)
    trs = tRT.run_routed(trs, torch_spec(spec_np), flow, steps, dt,
                         k_slots=k, k_fwd=k_fwd, draws=draws)
    assert_routers_close(jrs, trs, steps,
                         node_bytes_atol=trs.node_rx_packets.numpy())
    leaves = trs.node_rx_bytes[2:].double()
    assert (leaves > 2.0 ** 24).all() and (leaves < 2.0 ** 25).all()
    exact = float(start[0]) + 1501.0 * trs.node_rx_packets[2:].double()
    assert ((leaves - exact).abs() <= steps).all()
    assert (trs.node_rx_bytes.numpy()
            != np.asarray(jrs.node_rx_bytes)).any()


def test_run_routed_plain_shape_fn_equals_the_kernel_path_on_cpu():
    """`shape_fn` swaps the shaping of all k_slots + k_fwd slots for the
    plain step: on the CPU the two are the same program."""
    _, _, trs, spec_np, flow, k_fwd = both_routers("clos_ecmp")
    spec = torch_spec(spec_np)
    a = tRT.run_routed(trs, spec, flow, 15, 1000.0, 4, k_fwd, seed=4)
    b = tRT.run_routed(trs, spec, flow, 15, 1000.0, 4, k_fwd, seed=4,
                       shape_fn=tq.shape_packets_plain)
    x, y = convert.tree_to_numpy(a), convert.tree_to_numpy(b)
    for name in ROUTER_LEAVES:
        np.testing.assert_array_equal(x[name], y[name], err_msg=name)
    for group in ("edges", "inflight", "counters", "traffic"):
        for name in x["sim"][group]:
            np.testing.assert_array_equal(
                x["sim"][group][name], y["sim"][group][name],
                err_msg=f"{group}.{name}")
    assert a.node_rx_packets.sum() > 0


@pytest.mark.parametrize("name", ["line", "clos_ecmp"])
def test_router_state_round_trips_through_numpy(name):
    """convert.router_from_numpy takes the JAX state's leaves and
    tree_to_numpy gives them back, dtypes and all."""
    _, jrs, trs, _, _, _ = both_routers(name)
    want, got = convert.tree_to_numpy(jrs), convert.tree_to_numpy(trs)

    def walk(w, g, path):
        assert w.keys() == g.keys(), path
        for k in w:
            if isinstance(w[k], dict):
                walk(w[k], g[k], f"{path}.{k}")
            else:
                assert g[k].dtype == w[k].dtype, f"{path}.{k}"
                np.testing.assert_array_equal(g[k], w[k])

    walk(want, got, "rs")
    assert trs.next_edge.dim() == (3 if name == "clos_ecmp" else 2)
    sim_only = convert.sim_from_numpy(want["sim"], device="cpu")
    walk(want["sim"], convert.tree_to_numpy(sim_only), "sim")


def lanes_inputs(M, E, seed):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, E, M).astype(np.int32)
    target[rng.random(M) < 0.5] = 3         # one crowded row
    live = rng.random(M) < 0.7
    return (np.where(live, target, E).astype(np.int32),
            rng.choice([64.0, 1500.0], M).astype(np.float32),
            rng.integers(0, 9, M).astype(np.int32), rng.random(M) < 0.3,
            live)


@pytest.mark.parametrize("M,E,k_fwd", [(64, 8, 2), (200, 16, 8), (50, 4, 1),
                                       (300, 300, 4)])
def test_group_into_lanes_matches_jax(M, E, k_fwd):
    args = lanes_inputs(M, E, M + k_fwd)
    want = jax.jit(jRT._group_into_lanes, static_argnums=(5, 6))(
        *map(jnp.asarray, args), E, k_fwd)
    got = tRT._group_into_lanes(*map(torch.as_tensor, args), E, k_fwd)
    for g, w, name in zip(got, want, ("size", "dst", "corr", "ok",
                                      "dropped")):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    crowded = int((args[4] & (args[0] == 3)).sum())
    if crowded > k_fwd:     # the overflow of the crowded row is counted
        assert float(got[4]) >= crowded - k_fwd
        # the first k_fwd packets of the row, in flat order, get the lanes
        first = np.nonzero(args[4] & (args[0] == 3))[0][:k_fwd]
        np.testing.assert_array_equal(got[1][3].numpy(), args[2][first])


def test_ecmp_hash_wraps_like_uint32():
    ingress = torch.tensor([0, 1, 2, 70000, 262143])
    fd = torch.tensor([5, 599, 0, 123, 599])
    group = torch.tensor([[10, 11, 12, -1]] * 4 + [[-1, -1, -1, -1]],
                         dtype=torch.int32)
    got = tRT._ecmp_pick(group, ingress, fd)
    h = (ingress.numpy().astype(np.uint32) * np.uint32(2654435761)
         + fd.numpy().astype(np.uint32) * np.uint32(40503))
    want = np.where(np.arange(5) < 4, 10 + h % np.uint32(3), -1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_node_sums_are_exact_and_drop_foreign_nodes():
    vals = torch.tensor([1500.0, 64.0, 0.0, 3.25, 7.0])
    node = torch.tensor([2, 2, 1, 0, 9], dtype=torch.int32)
    got = tRT._node_sums(vals, node, 3)
    assert got.tolist() == [3.25, 0.0, 1564.0]


def test_routed_run_conserves_packets_and_repeats():
    """The port alone on its generator: per edge nothing is lost from the
    books, the fabric-wide transit balance closes, and the same seed
    gives the same bits."""
    el, _, trs, spec_np, flow, k_fwd = both_routers("clos_all_leaves")
    spec = torch_spec(spec_np)
    steps = 30
    out = tRT.run_routed(trs, spec, flow, steps, 1000.0, 4, k_fwd, seed=5)
    assert not tsim.conservation_residual(out.sim).any()
    c = out.sim.counters
    sourced = steps * int((spec.mode == 1).sum())   # one packet per ms
    reinjected = c.tx_packets.sum() - sourced
    pending = (out.pend_dst >= 0).sum()
    assert c.rx_packets.sum() == (out.node_rx_packets.sum() + reinjected
                                  + pending + out.fwd_dropped
                                  + out.no_route_dropped)
    again = tRT.run_routed(trs, spec, flow, steps, 1000.0, 4, k_fwd, seed=5)
    x, y = convert.tree_to_numpy(out), convert.tree_to_numpy(again)
    for name in ROUTER_LEAVES:
        np.testing.assert_array_equal(x[name], y[name], err_msg=name)
    for name in x["sim"]["counters"]:
        np.testing.assert_array_equal(x["sim"]["counters"][name],
                                      y["sim"]["counters"][name])


@pytest.mark.parametrize("k_paths", [None, 2])
def test_build_routed_entry_point(k_paths):
    el = tT.clos(2, 4, 0, props=LinkProperties(latency="1ms",
                                               rate="1Gbit"))
    state, _ = tT.load_edge_list_into_state(el, device="cpu")
    hosts = np.arange(2, 6)
    rs, spec, flow_dst, dist = entry.build_routed(
        el, state, hosts, seed=1, q=16, max_hops=4, k_paths=k_paths)
    src = torch.as_tensor(el.directed()[0])
    sourcing = flow_dst[:len(src)] >= 0
    assert torch.equal(sourcing, src >= 2)          # leaf -> spine rows
    assert (flow_dst[:len(src)][sourcing] != src[sourcing]).all()
    assert torch.isfinite(dist).all()
    assert rs.next_edge.dim() == (2 if k_paths is None else 3)
    out = tRT.run_routed(rs, spec, flow_dst, 12, 1000.0, 4, 8, seed=0)
    assert out.node_rx_packets[2:].sum() > 0
    assert out.node_rx_packets[:2].sum() == 0       # spines are transit
    assert float(out.no_route_dropped) == 0
    with pytest.raises(ValueError, match="two hosts"):
        entry.build_routed(el, state, [2], seed=1)
