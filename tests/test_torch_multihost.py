"""The port's multi-process meshes (kubedtn_tpu_torch/parallel/mesh.py:
init_distributed, make_multihost_mesh) on the CPU over gloo: the JAX
package's three multi-host cases (tests/test_multihost.py) with the same
inputs, each rank a child process that imports torch and the port only
(parallel/multihost.py), rendezvous through a file in tmp_path.

The JAX package's own multi-host tests skip here (its jaxlib has no gloo
transport), so the children's results are held against the JAX package's
SINGLE-process functions run in this process, within ROADMAP's
tolerances, and against the port's own single-process sharded runs, bit
for bit:

1. a 2-process x 2-shard reduce: arange(8) + 1 sums to 36 on both ranks,
   rank 0 holds rows 0 and 2 onward, rank 1 rows 4 and 6 onward;
2. the 2-process x 2-shard sharded step on tests/test_multihost.py's
   fat-tree: NodeStats the same on both ranks, delivered == tx_total > 0,
   row 0's latency 20 ms; the ranks' shards and NodeStats == the port's
   one-process 4-shard step, and == the JAX package's make_sharded_step
   on a 4-device CPU mesh (the same uniforms);
3. the 4-process x 2-shard sharded router on tests/test_multihost.py's
   chain (every hop on another shard, hops 2-3 across processes): every
   rank's node_rx_packets == the port's run_routed == the JAX package's
   router_step, nothing dropped, the gathered state == the one-process
   8-shard router, bit for bit.

And the rules in this process: the backend chosen from the layout, the
host-major order, init_distributed's no-op and its failures, and the step
and router refusing shards that are not this rank's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kubedtn_tpu import router as jRT
from kubedtn_tpu.api.types import LinkProperties as JLP
from kubedtn_tpu.models import topologies as jT
from kubedtn_tpu.models import traffic as jtr
from kubedtn_tpu.ops import edge_state as jes
from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu.ops import routing as jR
from kubedtn_tpu.parallel import mesh as jmesh
from kubedtn_tpu.parallel import sharded as jsh
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch import router as tRT
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.ops import edge_state as tes
from kubedtn_tpu_torch.parallel import mesh as pmesh
from kubedtn_tpu_torch.parallel import multihost as mh
from kubedtn_tpu_torch.parallel import router as tpr
from kubedtn_tpu_torch.parallel import sharded as tsh

from test_torch_netem import (assert_results_close, assert_states_close,
                              jax_state)
from test_torch_traffic import torch_spec

CHILD_TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def gloo():
    if not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo backend here")


def run_job(tmp_path, world, task, inputs, params, shards_per_rank=2):
    """One task of parallel/multihost.py on `world` CPU processes of
    `shards_per_rank` shards each: (each rank's result, its outputs)."""
    d = mh.write_job(tmp_path / "job", {task: params}, {task: inputs},
                     world=world, init=f"file://{tmp_path}/rendezvous",
                     devices=[["cpu"] * shards_per_rank] * world,
                     timeout_s=CHILD_TIMEOUT_S)
    res = mh.spawn(d, world, CHILD_TIMEOUT_S)
    for r, info in enumerate(res):
        assert info["rank"] == r and info["world_size"] == world
        assert info["backend"] == "gloo" and info["staging"] is None
        assert info["forbidden_modules"] == []
        assert info[task]["k1_launches"] == 0
    return ([info[task] | {"entries": info["entries"]} for info in res],
            [o[task] for o in mh.load_outputs(d, world)])


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


def test_two_process_mesh_reduce(tmp_path):
    res, _ = run_job(tmp_path, 2, "reduce",
                     {"data": torch.arange(8, dtype=torch.float32) + 1}, {})
    for r in res:
        assert r["entries"] == [[0, "cpu"], [0, "cpu"], [1, "cpu"],
                                [1, "cpu"]]
        assert r["total"] == 36.0
    assert res[0]["local_shard_starts"] == [0, 2]
    assert res[1]["local_shard_starts"] == [4, 6]


def test_a_failed_rank_fails_the_run_and_its_sibling_is_killed(tmp_path):
    """Rank 1 names a device that does not exist and exits after the
    rendezvous; rank 0, blocked in the layout exchange, is killed, and
    the run raises at once with rank 1's log, long before any timeout."""
    import time

    d = mh.write_job(tmp_path / "job", {"reduce": {}},
                     {"reduce": {"data": torch.ones(8)}}, world=2,
                     init=f"file://{tmp_path}/rendezvous",
                     devices=[["cpu"], ["no-such-device"]],
                     timeout_s=CHILD_TIMEOUT_S)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited"):
        mh.spawn(d, 2, CHILD_TIMEOUT_S)
    assert time.monotonic() - t0 < CHILD_TIMEOUT_S / 2
    assert "no-such-device" in (d / "log-1.txt").read_text()
    assert not (d / "result-0.json").exists()


# -- the sharded step ----------------------------------------------------

FAT_PROPS = dict(latency="10ms", jitter="1ms", loss="0.5", rate="1Gbit")
B = 8


def step_inputs():
    """tests/test_multihost.py's step: the fat-tree in 64 rows, 1,500 B
    on every loaded row, an 8-row batch to 20 ms / 100 Mbit; the
    uniforms are what the JAX step draws from key(0)."""
    el = jT.fat_tree(4, JLP(**FAT_PROPS))
    jstate, rows = jT.load_edge_list_into_state(el, capacity=64)
    E = jstate.capacity
    d = convert.tree_to_numpy(jstate)
    x = dict(rows=np.arange(B, dtype=np.int32),
             props=np.stack([tes.props_row(LinkProperties(
                 latency="20ms", rate="100Mbit").to_numeric())] * B),
             valid=np.ones(B, bool),
             sizes=np.full(E, 1500.0, np.float32),
             have=np.arange(E) < len(rows),
             t_arr=np.zeros(E, np.float32))
    key = jax.random.key(0)
    u = np.array(jax.random.uniform(key, (E, jnetem.NU), jnp.float32))
    return el.n_nodes, d, x, key, u


def test_two_process_sharded_step(tmp_path, devices8):
    n, d, x, key, u = step_inputs()
    tx = {k: torch.as_tensor(np.array(v)) for k, v in x.items()}
    _, outs = run_job(
        tmp_path, 2, "step",
        {"state": convert.edge_state_from_numpy(d, device="cpu"),
         "steps": [dict(tx, u=torch.as_tensor(u))]}, {"n_nodes": n})
    a, b = (o["stats"][0] for o in outs)
    same_bits(a, b, "NodeStats on the two ranks")
    delivered = sum(int(r.delivered.sum()) for o in outs
                    for r in o["results"][0])
    assert delivered > 0 and float(a.tx_packets.sum()) == delivered
    lat = tes.PROP_NAMES.index("latency_us")
    assert float(outs[0]["shards"][0].props[0, lat]) == 20_000.0

    # == the port's one-process step on 4 shards, bit for bit
    mesh = pmesh.make_mesh(["cpu"] * 4)
    shards = pmesh.shard_edge_state(
        convert.edge_state_from_numpy(d, device="cpu"), mesh)
    want, want_res, want_stats = tsh.make_sharded_step(mesh, n)(
        shards, tx["rows"], tx["props"], tx["valid"], tx["sizes"],
        tx["have"], tx["t_arr"], u=torch.as_tensor(u))
    got = [s for o in outs for s in o["shards"]]
    got_res = [r for o in outs for r in o["results"][0]]
    for s in range(4):
        same_bits(got[s], want[s], f"shard {s}")
        same_bits(got_res[s], want_res[s], f"shard {s} ShapeResult")
    same_bits(a, want_stats, "NodeStats")

    # == the JAX package's make_sharded_step on 4 CPU devices
    m = jmesh.make_mesh(4)
    jstep = jsh.make_sharded_step(m, n_nodes=n)
    js, jres, jstats = jstep(
        jmesh.shard_edge_state(jax_state(d), m),
        *(jnp.asarray(x[k]) for k in ("rows", "props", "valid", "sizes",
                                      "have", "t_arr")), key)
    assert_states_close(js, convert.unshard(got))
    assert_results_close(jres, convert.unshard(got_res))
    for f in dataclasses.fields(tsh.NodeStats):
        want_j = np.asarray(getattr(jstats, f.name))
        got_t = getattr(a, f.name).numpy()
        if f.name.endswith("bytes"):
            np.testing.assert_allclose(got_t, want_j, rtol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got_t, want_j, err_msg=f.name)


# -- the sharded router ------------------------------------------------

E_CHAIN, N_SHARDS, N_NODES, STEPS, DT_US = 32, 8, 5, 12, 2000.0


def chain():
    """tests/test_multihost.py's router case: a chain 0 -> 1 -> ... -> 4
    with hop i's row on shard i of 8, CBR 8 Mbit/s of 1,000 B on row 0
    bound for node 4. Returns the JAX RouterState, spec and flows."""
    e_loc = E_CHAIN // N_SHARDS
    n_links = N_NODES - 1
    rows = np.arange(n_links, dtype=np.int32) * e_loc
    props = np.zeros((n_links, jes.NPROP), np.float32)
    props[:, jes.P_LATENCY_US] = 1000.0
    state = jes.apply_links(
        jes.init_state(E_CHAIN), jnp.asarray(rows),
        jnp.arange(1, n_links + 1, dtype=jnp.int32),
        jnp.arange(n_links, dtype=jnp.int32),
        jnp.arange(1, n_links + 1, dtype=jnp.int32),
        jnp.asarray(props), jnp.ones(n_links, dtype=bool))
    _, nh = jR.recompute_routes(state, N_NODES, max_hops=8)
    rs0 = jRT.init_router(state, nh, N_NODES, q=32, k_fwd=8)
    mode = np.zeros(E_CHAIN, np.int32)
    mode[rows[0]] = jtr.MODE_CBR
    rate = np.zeros(E_CHAIN, np.float32)
    rate[rows[0]] = 8e6
    z = np.zeros(E_CHAIN, np.float32)
    spec = jtr.TrafficSpec(
        mode=jnp.asarray(mode), rate_bps=jnp.asarray(rate),
        pkt_bytes=jnp.full((E_CHAIN,), 1000.0, jnp.float32),
        on_us=jnp.asarray(z), off_us=jnp.asarray(z))
    flow_dst = np.full(E_CHAIN, -1, np.int32)
    flow_dst[rows[0]] = N_NODES - 1
    return rs0, spec, flow_dst


def test_four_process_sharded_router(tmp_path):
    jrs, spec_j, flow_dst = chain()
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs),
                                    device="cpu")
    spec = torch_spec(convert.tree_to_numpy(spec_j))
    seed = 7
    res, outs = run_job(
        tmp_path, 4, "router",
        {"edges": trs.sim.edges, "next_edge": trs.next_edge, "spec": spec,
         "flow_dst": torch.as_tensor(flow_dst)},
        dict(n_nodes=N_NODES, q=32, k_fwd=8, k_slots=2, budget=64,
             dt_us=DT_US, steps=STEPS, seed=seed, gather=True))

    # the JAX package's one-device router and the port's run_routed (the
    # chain is latency-only CBR: no draw reaches a result)
    jrs_i = jrs
    for i in range(STEPS):
        jrs_i = jRT.router_step(jrs_i, spec_j, jnp.asarray(flow_dst),
                                jax.random.key(i), 2, 8,
                                jnp.float32(DT_US))
    ref_rx = np.asarray(jrs_i.node_rx_packets).tolist()
    rr = tRT.run_routed(trs, spec, flow_dst, STEPS, DT_US, 2, 8)
    assert rr.node_rx_packets.tolist() == ref_rx
    assert ref_rx[-1] > 0
    for r in res:
        assert len(r["entries"]) == 8
        assert r["node_rx_packets"] == ref_rx
        assert r["fwd_dropped"] == 0 and r["no_route_dropped"] == 0

    # == the one-process 8-shard router on the same generators
    mesh = pmesh.make_mesh(["cpu"] * N_SHARDS)
    step = tpr.make_sharded_router_step(mesh, N_NODES, k_slots=2, k_fwd=8,
                                        budget=64)
    shards = tpr.shard_router_state(
        tRT.init_router(trs.sim.edges, trs.next_edge, N_NODES, q=32,
                        k_fwd=8), mesh)
    gens = tpr.shard_generators(mesh, seed)
    for _ in range(STEPS):
        shards = step(shards, spec, flow_dst, gens, DT_US)
    want = tpr.gather_router_state(shards)
    for r, o in enumerate(outs):
        same_bits(o["gathered"], want, f"rank {r}'s gathered state")
        for j, s in enumerate(o["shards"]):
            same_bits(s, shards[2 * r + j], f"rank {r} shard {j}")


# -- the rules, in this process ------------------------------------------

E_ = pmesh.MeshEntry


@pytest.mark.parametrize("entries,want", [
    ([E_(0, "cpu", None), E_(1, "cpu", None)], "gloo"),
    ([E_(0, "cuda:0", "h/GPU-a"), E_(0, "cuda:0", "h/GPU-a"),
      E_(1, "cuda:0", "h/GPU-a"), E_(1, "cuda:0", "h/GPU-a")], "gloo"),
    ([E_(0, "cuda:0", "h/GPU-a"), E_(1, "cuda:1", "h/GPU-b")], "nccl"),
    ([E_(0, "cuda:0", "h/GPU-a"), E_(0, "cuda:1", "h/GPU-b"),
      E_(1, "cuda:0", "g/GPU-c"), E_(1, "cuda:1", "g/GPU-d")], "nccl"),
    ([E_(0, "cuda:0", "h/GPU-a"), E_(1, "cpu", None)], "gloo"),
])
def test_backend_follows_the_layout(entries, want):
    assert pmesh.choose_backend(entries) == want


def test_host_major_order_and_equal_shares():
    got = pmesh.host_major([[("cpu", None), ("cpu", None)],
                            [("cuda:0", "h/a"), ("cuda:1", "h/b")]])
    assert [(e.rank, e.device) for e in got] == [
        (0, "cpu"), (0, "cpu"), (1, "cuda:0"), (1, "cuda:1")]
    with pytest.raises(ValueError, match="same number of shards"):
        pmesh.host_major([[("cpu", None)], [("cpu", None)] * 2])


def test_init_distributed_is_a_noop_once_up_and_raises_otherwise(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs num_processes"):
        pmesh.init_distributed("127.0.0.1:1234")
    # a rendezvous that no second process joins
    with pytest.raises(Exception, match="(?i)time"):
        pmesh.init_distributed(f"file://{tmp_path}/lonely", 2, 0,
                               timeout_s=2.0)
    assert not dist.is_initialized()
    pmesh.init_distributed(f"file://{tmp_path}/alone", 1, 0)
    try:
        assert dist.get_world_size() == 1
        pmesh.init_distributed(f"file://{tmp_path}/other", 5, 3)  # no-op
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
    finally:
        dist.destroy_process_group()


def rank1_of_4(device="cpu"):
    """Rank 1's view of a 2 x 2 mesh, built without a process group."""
    return pmesh.MultihostMesh(
        entries=pmesh.host_major([[(device, None)] * 2] * 2), rank=1,
        world_size=2, backend="gloo")


def test_step_and_router_refuse_shards_that_are_not_this_ranks():
    mesh = rank1_of_4()
    assert pmesh.local_shards(mesh) == [(2, torch.device("cpu")),
                                        (3, torch.device("cpu"))]
    assert pmesh.replicated(mesh) == (torch.device("cpu"),)
    state = tes.init_state(64, device="cpu")
    mine = pmesh.shard_edge_state(state, mesh)
    assert [s.capacity for s in mine] == [16, 16]
    all4 = pmesh.shard_edge_state(state, pmesh.make_mesh(["cpu"] * 4))
    step = tsh.make_sharded_step(mesh, 8)
    z = torch.zeros(64)
    args = ([], np.zeros((0, tes.NPROP), np.float32), [], z, z.bool(), z,
            torch.Generator())
    with pytest.raises(ValueError, match="4 shards for the 2 shards "
                                         "process 1 holds of a mesh of 4"):
        step(all4, *args)
    with pytest.raises(ValueError, match="shard 2 lies on cpu, its mesh "
                                         "device is cuda:0"):
        tsh.make_sharded_step(rank1_of_4("cuda:0"), 8)(mine, *args)

    jrs, spec_j, flow_dst = chain()
    trs = convert.router_from_numpy(convert.tree_to_numpy(jrs),
                                    device="cpu")
    rmine = tpr.shard_router_state(trs, mesh)
    rall = tpr.shard_router_state(trs, pmesh.make_mesh(["cpu"] * 4))
    for got, want in zip(rmine, rall[2:]):
        same_bits(got, want)
    assert [g.initial_seed() for g in tpr.shard_generators(mesh, 3)] == [
        3 * 65536 + 2, 3 * 65536 + 3]
    rstep = tpr.make_sharded_router_step(mesh, N_NODES, k_slots=2)
    with pytest.raises(ValueError, match="4 shards for the 2 shards"):
        rstep(rall, torch_spec(convert.tree_to_numpy(spec_j)), flow_dst,
              None, DT_US, draws=[None] * 4)


def test_chip_smoke_phase_25_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 25 on the CPU at an 8 x 20 Clos (640 rows in
    1,024): 2 processes x 2 shards run the sharded step and the sharded
    router, every rank's shards == one process's, bit for bit (the
    launch counts pass vacuously without a card)."""
    import chip_smoke as cs
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.models.topologies import (
        clos, load_edge_list_into_state, random_link_props)

    monkeypatch.setattr(cs, "SH_BATCH", 100)
    monkeypatch.setattr(cs, "SR_BUDGET", 1 << 10)
    dev = torch.device("cpu")
    el = clos(8, 20, 0, props=LinkProperties(latency="10ms", rate="10Gbit"),
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
    m, k1, k1_one = cs.run_multiprocess_phase(
        el, state, dev, "cpu", routed=routed, layout=[["cpu", "cpu"]] * 2)
    assert (k1, k1_one) == (0, 0)
    assert (m["backend"], m["staging"]) == ("gloo", None)
    assert m["b"]["books"]["reinjected"] > 0 and m["b"]["over_budget"] == 0
    assert m["b"]["a2a_bytes_per_step"] == 2 * 2 * 4 * (1 << 10) * 16
