"""Entry points of the port: the flagship shaping step and the 100k-link
Clos, the counterparts of __graft_entry__.entry() and bench.py's build(),
and the class groups of one live tick.

`entry()` returns the drop-in shaping step over a k=8 fat-tree edge
state (80 switches, 256 links -> 512 directed rows in capacity 1024)
plus example arguments. On the card the step runs kernel K1.
`build_live_tick` packs the groups that runtime.fused_tick (and its
sharded form, whose ring steps run kernel K4) shapes in one tick.
`build_sim` and `build_routed` assemble the K-slot simulator and the
routed fabric over a loaded topology (each slot of a step is one launch
of kernel K1 on the card). Like the others they work on the device the
state lies on, and the loaders put the state on the card by default.

`build_daemon` builds the same 100k-link Clos the way a KubeDTN cluster
does — 600 Topology CRs through the store, the reconciler and the
SimEngine — behind a wire Daemon, and `build_plane` puts the live
WireDataPlane on top of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.models.topologies import (clos, fat_tree,
                                                 load_edge_list_into_state)
from kubedtn_tpu_torch.ops import netem

# BASELINE's 100k-link Clos (bench.py): 100 spines x 500 leaves, two
# parallel links per pair -> 200,000 directed rows in capacity 2^18.
N_SPINE, N_LEAF, LINKS_PER_PAIR = 100, 500, 2


def _build(device, capacity: int = 1024):
    props = LinkProperties(latency="10ms", jitter="1ms", loss="0.5",
                           rate="1Gbit")
    el = fat_tree(8, props)
    state, rows = load_edge_list_into_state(el, capacity=capacity,
                                            device=device)
    E = state.capacity
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=device)
    have = torch.as_tensor(np.arange(E) < len(rows), device=device)
    t_arr = torch.zeros((E,), dtype=torch.float32, device=device)
    return el, state, sizes, have, t_arr


def entry(device=None):
    """(fn, example_args): one drop-in shaping step (netem+TBF over every
    edge) on the flagship fat-tree, without donating the state. `device`
    None means the CUDA card."""
    dev = resolve_device(device)
    _, state, sizes, have, t_arr = _build(dev)
    generator = torch.Generator(device=dev).manual_seed(0)

    def fwd(state, sizes, have, t_arr, generator):
        return netem.shape_step_nodonate(state, sizes, have, t_arr,
                                         generator)

    return fwd, (state, sizes, have, t_arr, generator)


def link_key_id(row: int) -> int:
    """A stable 64-bit key id for a row: a multiplicative hash of it,
    standing in for the engine's (pod, uid) link identity."""
    return ((int(row) + 1) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF


def build_live_tick(el, state, n_rows_per_class: int, k_slots: int, seed,
                    device=None) -> dict:
    """One live tick's class groups over the topology `el` loaded in
    `state` (rows 0..2L-1, as load_edge_list_into_state places them).

    The rows' properties are first rewritten with one UpdateLinks
    (`random_link_props(2L, seed)`), in thirds, one per kernel class:
    the first third stays as drawn (rate > 0, iid: the max-plus TBF
    class), the second gets rate 0 (slot-independent), the last
    loss_corr 25 % and reorder 1 % (sequential). `state` is updated in
    place. Then `n_rows_per_class` busy rows are drawn from each third,
    each with 1..`k_slots` frames of 64-1500 bytes (one row with
    exactly k_slots), and packed by runtime._build_group onto `device`
    (None = the CUDA card). Returns {"tbf": quad, "seq": quad, "ind":
    quad}: the (row_idx, sizes, valid, key_ids) groups of one tick."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch.models.topologies import random_link_props
    from kubedtn_tpu_torch.ops import edge_state as es

    dev = resolve_device(device)
    n = 2 * el.n_links
    third = n // 3
    props = random_link_props(n, seed)
    props[third:2 * third, es.P_RATE_BPS] = 0.0
    props[2 * third:, es.P_LOSS_CORR] = 25.0
    props[2 * third:, es.P_REORDER_PROB] = 1.0
    es.update_links(state, np.arange(n, dtype=np.int32), props,
                    np.ones(n, dtype=bool), contiguous=True)
    ranges = {"tbf": (0, third), "ind": (third, 2 * third),
              "seq": (2 * third, n)}
    predicate = {"tbf": netem.tbf_batch_rows,
                 "ind": netem.slot_independent_rows,
                 "seq": lambda p: ~netem.tbf_batch_rows(p)
                 & ~netem.slot_independent_rows(p)}
    rng = np.random.default_rng(seed)
    batches, groups = [], {}
    for kind, (lo, hi) in ranges.items():
        if not bool(predicate[kind](props[lo:hi]).all()):
            raise AssertionError(f"rows [{lo}, {hi}) are not all {kind}")
        rows = np.sort(rng.choice(np.arange(lo, hi), n_rows_per_class,
                                  replace=False))
        counts = rng.integers(1, k_slots + 1, n_rows_per_class)
        counts[0] = k_slots
        groups[kind] = list(range(len(batches),
                                  len(batches) + n_rows_per_class))
        for r, m in zip(rows, counts):
            lens = rng.integers(64, 1501, m).astype(np.float32)
            batches.append((None, int(r), lens, None, False))
    keyid_map = {b[1]: link_key_id(b[1]) for b in batches}
    return {kind: runtime._build_group(batches, groups[kind],
                                       state.capacity, keyid_map, dev)
            for kind in ("tbf", "seq", "ind")}


def build_sim(el, state, rate_bps: float = 12e6, pkt_bytes: float = 1500.0,
              q: int = 128):
    """The K-slot simulator over the topology `el` loaded in `state`
    (rows 0..2L-1), on the state's device: CBR at `rate_bps` on every
    directed row, a delay line of `q` slots per edge. Returns (sim,
    spec) for sim.run / sim.sim_step."""
    from kubedtn_tpu_torch import sim
    from kubedtn_tpu_torch.models.traffic import cbr_everywhere

    spec = cbr_everywhere(state.capacity, 2 * el.n_links, rate_bps,
                          pkt_bytes, device=state.device)
    return sim.init_sim(state, q=q), spec


def build_routed(el, state, hosts, seed: int, rate_bps: float = 12e6,
                 pkt_bytes: float = 1500.0, q: int = 128, k_fwd: int = 8,
                 max_hops: int = 16, k_paths: int | None = None):
    """The routed fabric over the topology `el` loaded in `state`, on
    the state's device: routes recomputed from the state (single-path,
    or ECMP groups of `k_paths`), and one CBR flow on every directed row
    whose source is one of the nodes `hosts`, bound for another host: a
    fixed permutation of the hosts drawn from `seed`, all rows of one
    host sharing its target. Returns (rs, spec, flow_dst, dist) for
    router.run_routed / router.router_step."""
    from kubedtn_tpu_torch import router
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import routing

    dev = state.device
    hosts = np.asarray(hosts, dtype=np.int64)
    if len(hosts) < 2:
        raise ValueError("build_routed needs at least two hosts")
    order = np.random.default_rng(seed).permutation(hosts)
    target = np.full(el.n_nodes, -1, dtype=np.int32)
    target[order] = np.roll(order, 1)   # one cycle: nobody targets itself
    src = el.directed()[0]
    flow_np = np.full(state.capacity, -1, dtype=np.int32)
    flow_np[:len(src)] = target[src]
    flow_dst = torch.as_tensor(flow_np, device=dev)
    sourcing = flow_dst >= 0
    spec = traffic.cbr_everywhere(state.capacity, 0, 0.0, pkt_bytes,
                                  device=dev)
    spec = dataclasses.replace(
        spec,
        mode=torch.where(sourcing, traffic.MODE_CBR,
                         traffic.MODE_OFF).to(torch.int32),
        rate_bps=torch.where(sourcing, float(rate_bps), 0.0))
    if k_paths is None:
        dist, nh = routing.recompute_routes(state, el.n_nodes, max_hops)
    else:
        dist, nh = routing.recompute_routes_ecmp(state, el.n_nodes,
                                                 k_paths, max_hops)
    rs = router.init_router(state, nh, el.n_nodes, q=q, k_fwd=k_fwd)
    return rs, spec, flow_dst, dist


def build_clos_100k(device=None):
    """The 100k-link Clos loaded on `device` (None = the CUDA card):
    returns (edge list, state, rows), as bench.py's build()."""
    dev = resolve_device(device)
    el = clos(N_SPINE, N_LEAF, hosts_per_leaf=0,
              props=LinkProperties(latency="10ms", rate="10Gbit"),
              links_per_pair=LINKS_PER_PAIR)
    if el.n_links != 100_000:
        raise AssertionError(f"expected 100,000 links, got {el.n_links}")
    state, rows = load_edge_list_into_state(el, device=dev)
    return el, state, rows


def clos_crs(n_spine: int = N_SPINE, n_leaf: int = N_LEAF,
             links_per_pair: int = LINKS_PER_PAIR, props=None,
             node_ip: str = "10.0.0.1"):
    """The Clos as Topology CRs, as the JAX package's reconcile_100k
    scenario writes them: one CR per spine and per leaf, link uids
    1..n_spine*n_leaf*links_per_pair, every pod placed on `node_ip`
    (the CNI ran) with no link realized yet (status.links = [])."""
    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec

    props = props or LinkProperties(latency="10ms", rate="10Gbit")
    spines = [[] for _ in range(n_spine)]
    leaves = [[] for _ in range(n_leaf)]
    uid = 0
    for s in range(n_spine):
        for l in range(n_leaf):
            for k in range(links_per_pair):
                uid += 1
                spines[s].append(Link(
                    local_intf=f"e{l}-{k}", peer_intf=f"e{s}-{k}",
                    peer_pod=f"leaf{l}", uid=uid, properties=props))
                leaves[l].append(Link(
                    local_intf=f"e{s}-{k}", peer_intf=f"e{l}-{k}",
                    peer_pod=f"spine{s}", uid=uid, properties=props))
    out = []
    for name, links in ([(f"spine{s}", x) for s, x in enumerate(spines)]
                        + [(f"leaf{l}", x) for l, x in enumerate(leaves)]):
        t = Topology(name=name, spec=TopologySpec(links=links))
        t.status.src_ip, t.status.net_ns = node_ip, f"/run/netns/{name}"
        t.status.links = []
        out.append(t)
    return out


def build_daemon(device=None, n_spine: int = N_SPINE, n_leaf: int = N_LEAF,
                 links_per_pair: int = LINKS_PER_PAIR,
                 capacity: int = 1 << 18, props=None,
                 node_ip: str = "10.0.0.1") -> dict:
    """The Clos through the control plane on `device` (None = the CUDA
    card): `clos_crs` into a TopologyStore, one reconciler drain into a
    SimEngine of `capacity` rows, the engine flushed, a Daemon in front.
    Returns {"store", "engine", "reconciler", "daemon", "crs",
    "reconcile_s"} — reconcile_s is the drain plus the device flush,
    ended by a device sync."""
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon

    import time

    dev = resolve_device(device)
    store = TopologyStore()
    engine = SimEngine(store, capacity=capacity, node_ip=node_ip,
                       device=dev)
    crs = clos_crs(n_spine, n_leaf, links_per_pair, props, node_ip)
    for t in crs:
        store.create(t)
    engine.warm_kernels()
    rec = Reconciler(store, engine)
    t0 = time.perf_counter()
    rec.drain()
    engine.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reconcile_s = time.perf_counter() - t0
    n_links = n_spine * n_leaf * links_per_pair
    if engine.num_active != 2 * n_links:
        raise AssertionError(f"{engine.num_active} rows realized, "
                             f"expected {2 * n_links}")
    return {"store": store, "engine": engine, "reconciler": rec,
            "daemon": Daemon(engine), "crs": crs,
            "reconcile_s": reconcile_s}


def build_plane(daemon, **kwargs):
    """The live WireDataPlane over `daemon` (its engine's device);
    `kwargs` go to WireDataPlane (dt_us, max_slots, seed,
    pipeline_depth)."""
    from kubedtn_tpu_torch.runtime import WireDataPlane

    return WireDataPlane(daemon, **kwargs)
