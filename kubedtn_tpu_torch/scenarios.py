"""Scenarios of the port, runnable functions returning a result dict.

Port of kubedtn_tpu/scenarios.py, in part. Nine of the BASELINE rungs:
`three_node` ("3node", a sample through the control plane and a ping
per link), `fat_tree_64`, `churn_1k`, `routes_10k` (route recomputes
on link events), `clos_100k`, `reconcile_100k` (reconcile-to-steady at
100k links through store, reconciler and engine), `scale_1m`
(UpdateLinks and a K1 step over 2M rows), `chaos_flaps` (link flaps
under routed traffic) and `reconverge_10k` (incremental reconvergence
on a three-tier fabric). Then
`_tenant_plane_setup` (the multi-tenant plane harness),
`burn_recovery` (the SLO autopilot's
closed loop on one live plane), `migration_under_flap` (a live tenant
migration between two gRPC daemons under a flapping peer), and the fleet
supervisor's two: `plane_failover` (a plane killed mid-migration and
evacuated with no operator call) and `fleet_rolling_upgrade` (two gRPC
daemons upgraded one at a time under load). Each takes a `device`, None
meaning the CUDA card, and returns the JAX scenario's keys (and
"device"). `LADDER` holds these thirteen in the order of the JAX
module's ladder (what `tpudtn-torch scenario` runs); `NOT_PORTED` names
the rest of that ladder (the soaks, noisy_neighbor, whatif_sweep, ...),
still to be ported.
"""

from __future__ import annotations

import dataclasses
import time
import types
from pathlib import Path

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.api.types import LinkProperties


def wire_def(pod: str, ns: str, uid: int):
    """A WireDef-shaped object (the Daemon takes its attribute names),
    so the harness needs no protobuf."""
    return types.SimpleNamespace(
        local_pod_name=pod, kube_ns=ns, link_uid=uid,
        intf_name_in_pod="eth1", veth_name_local_host="", peer_intf_id=0,
        peer_ip="")


# -- the BASELINE rungs (kubedtn_tpu/scenarios.py:36-406) -----------------

# the repo's own sample (four pods in a shaped ring), resolved from the
# package's location
RING4_YAML = str(Path(__file__).resolve().parent.parent / "config"
                 / "samples" / "ring4.yaml")


def _sync(dev) -> None:
    """Wait for the card's queued work (the JAX rungs'
    block_until_ready); nothing to wait for on the CPU."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _keyed_generator(dev, key: int, i: int):
    """The generator of iteration `i` under `key`: seeded from one
    Philox call with the iteration in the counter (the port's keyed
    draws, where the JAX rung folds `i` into a threefry key; the bits
    differ between the packages)."""
    import torch

    from kubedtn_tpu_torch.ops.cuda import philox

    w = philox.philox4x32_words((i & philox.MASK32, 0, 0, 0),
                                (key & philox.MASK32,
                                 (key >> 32) & philox.MASK32))
    return torch.Generator(device=dev).manual_seed(
        (w[0] | (w[1] << 32)) & 0x7FFFFFFFFFFFFFFF)


def three_node(yaml_path: str = RING4_YAML, device=None):
    """Rung 1: a sample through the full control plane — store, setup
    of every pod, one reconciler drain, a ping over every link (kernel
    K1 on the card). The JAX rung reads the reference's
    config/samples/3node.yml, which is not in this repo; the default
    here is the repo's config/samples/ring4.yaml."""
    from kubedtn_tpu_torch.api.types import load_yaml
    from kubedtn_tpu_torch.topology import (Reconciler, SimEngine,
                                            TopologyStore)

    dev = resolve_device(device)
    t0 = time.perf_counter()
    store = TopologyStore()
    engine = SimEngine(store, capacity=64, device=dev)
    topos = load_yaml(yaml_path)
    for t in topos:
        store.create(t)
    for t in topos:
        engine.setup_pod(t.name, t.namespace)
    rec = Reconciler(store, engine)
    rec.drain()
    pings = {}
    uids = sorted({l.uid for t in topos for l in t.spec.links})
    pairs = {}
    for t in topos:
        for l in t.spec.links:
            pairs.setdefault(l.uid, (t.name, l.peer_pod))
    for uid in uids:
        a, b = pairs[uid]
        pings[f"{a}<->{b}"] = engine.ping(a, b, uid)
    return {
        "scenario": "3node",
        "device": str(dev),
        "links": engine.num_active // 2,
        "reachable": all(p["reachable"] for p in pings.values()),
        "pings": {k: v["rtt_us"] for k, v in pings.items()},
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def fat_tree_64(k: int = 8, steps: int = 200, dt_us: float = 1000.0,
                device=None):
    """Rung 2: k=8 fat-tree (80 switches), static latency+bw shaping,
    CBR traffic on every link, through the K-slot simulator (each
    shaping slot one launch of K1 on the card)."""
    from kubedtn_tpu_torch import sim as S
    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.models.traffic import cbr_everywhere

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.fat_tree(k, LinkProperties(latency="50us", rate="10Gbit"))
    state, rows = T.load_edge_list_into_state(el, device=dev)
    sim = S.init_sim(state)
    spec = cbr_everywhere(state.capacity, len(rows), rate_bps=1e9,
                          device=dev)
    sim = S.run(sim, spec, steps=steps, dt_us=dt_us, k_slots=8)
    c = sim.counters
    return {
        "scenario": "fat_tree_64",
        "device": str(dev),
        "nodes": el.n_nodes,
        "links": el.n_links,
        "sim_time_s": steps * dt_us / 1e6,
        "tx_packets": float(c.tx_packets.sum()),
        "rx_packets": float(c.rx_packets.sum()),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def churn_1k(n_nodes: int = 1000, n_links: int = 3000,
             churn_frac_per_s: float = 0.10, seconds: float = 5.0,
             device=None):
    """Rung 3: 1k-node random mesh with 10%-of-links-per-second property
    churn through the batched UpdateLinks path (in place on the
    state's tensors)."""
    import numpy as np

    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.ops import edge_state as es

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.random_mesh(n_nodes, n_links, seed=7,
                       props=LinkProperties(latency="1ms"))
    state, rows = T.load_edge_list_into_state(el, device=dev)
    rng = np.random.default_rng(0)
    batch = int(n_links * churn_frac_per_s)
    n_batches = int(seconds)
    lat_choices = np.array([1_000, 5_000, 10_000, 50_000], np.float32)
    # warmup: one all-padding batch (no row changes) before timing
    wp = np.zeros((batch, es.NPROP), np.float32)
    state = es.update_links(state, np.arange(batch, dtype=np.int32), wp,
                            np.zeros(batch, dtype=bool))
    _sync(dev)
    # enqueue every churn batch, sync once
    tb = time.perf_counter()
    for i in range(n_batches):
        pick = rng.choice(n_links, batch, replace=False).astype(np.int32)
        props = np.zeros((batch, es.NPROP), np.float32)
        props[:, es.P_LATENCY_US] = rng.choice(lat_choices, batch)
        state = es.update_links(state, pick, props,
                                np.ones(batch, dtype=bool))
    _sync(dev)
    upd_time = time.perf_counter() - tb
    return {
        "scenario": "churn_1k",
        "device": str(dev),
        "nodes": n_nodes,
        "links": n_links,
        "churn_links_total": batch * n_batches,
        "updates_per_sec": round(batch * n_batches / upd_time, 1),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def routes_10k(n_nodes: int = 10_000, n_links: int = 30_000,
               events: int = 3, dst_chunk: int = 1000, device=None):
    """Rung 4: 10k-node shortest-path recompute on link up/down events —
    the BGP-convergence analogue as batched min-plus relaxation on the
    device (no shaping: no kernel of the port is launched)."""
    import numpy as np

    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import routing as R

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.random_mesh(n_nodes, n_links, seed=11,
                       props=LinkProperties(latency="1ms"))
    state, rows = T.load_edge_list_into_state(el, device=dev)
    recompute_times = []
    rng = np.random.default_rng(1)
    for _ in range(events):
        # link event: take a random link down (both directions)
        pick = int(rng.integers(0, el.n_links))
        state = es.delete_links(
            state, np.array([pick, pick + el.n_links], np.int32),
            np.ones(2, dtype=bool))
        _sync(dev)
        tb = time.perf_counter()
        dist, nh = R.recompute_routes(state, n_nodes, max_hops=12,
                                      dst_chunk=dst_chunk)
        _sync(dev)
        recompute_times.append(time.perf_counter() - tb)
    finite = int(dist.isfinite().sum()) / dist.numel()
    return {
        "scenario": "routes_10k",
        "device": str(dev),
        "nodes": n_nodes,
        "links": n_links,
        "recompute_s_first": round(recompute_times[0], 3),
        "recompute_s_steady": round(float(np.mean(recompute_times[1:])), 3)
        if len(recompute_times) > 1 else None,
        "reachable_frac": round(finite, 4),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def clos_100k(steps: int = 50, dt_us: float = 1000.0, device=None):
    """Rung 5: 100k-link Clos with per-link loss+jitter and packet queues
    — the full data plane at BASELINE scale (each shaping slot one
    launch of K1 on the card)."""
    from kubedtn_tpu_torch import sim as S
    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.models.traffic import cbr_everywhere

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.clos(100, 500, 0,
                props=LinkProperties(latency="10us", jitter="5us",
                                     loss="0.01", rate="100Gbit"),
                links_per_pair=2)
    state, rows = T.load_edge_list_into_state(el, device=dev)
    sim = S.init_sim(state, q=8)
    spec = cbr_everywhere(state.capacity, len(rows), rate_bps=1e9,
                          device=dev)
    tb = time.perf_counter()
    sim = S.run(sim, spec, steps=steps, dt_us=dt_us, k_slots=2)
    _sync(dev)
    step_time = time.perf_counter() - tb
    c = sim.counters
    tx = float(c.tx_packets.sum())
    rx = float(c.rx_packets.sum())
    lost = float(c.dropped_loss.sum())
    return {
        "scenario": "clos_100k",
        "device": str(dev),
        "links": el.n_links,
        "directed_edges": 2 * el.n_links,
        "sim_time_s": steps * dt_us / 1e6,
        "tx_packets": tx,
        "rx_packets": rx,
        "loss_rate": round(lost / max(tx, 1), 6),
        "packet_events_per_sec": round(tx / step_time, 1),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def reconcile_100k(n_spine: int = 100, n_leaf: int = 500,
                   links_per_pair: int = 2, workers: int = 1,
                   grpc_batch: int = 1000, device=None):
    """Rung 6: reconcile-to-steady at 100k links through the REAL control
    path — store → reconciler → engine (BASELINE "reconcile-to-steady <5s
    @100k links"; reference contract controllers/topology_controller.go:
    61-156). Every link enters as a Link in a Topology CR, is diffed by
    the reconciler, allocated a row by the engine, and lands on the card
    via the engine's coalesced flush.

    Four measured phases (the whole lifecycle):
    - reconcile_s: 600 CRs / 100k links / 200k directed rows from empty
      status to fully realized + status copied back;
    - churn_s:   every link's properties replaced through spec updates,
      re-reconciled (the UpdateLinks path end to end);
    - grpc_update_s: one live-daemon Local.UpdateLinks round trip for a
      `grpc_batch`-link batch over real gRPC (wire-serialization cost);
    - teardown_s: every pod destroyed (CNI cmdDel → DestroyPod path,
      reference handler.go:538-590) back to zero active rows.
    """
    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.topology import (Reconciler, SimEngine,
                                            TopologyStore)

    dev = resolve_device(device)
    t0 = time.perf_counter()
    store = TopologyStore()
    engine = SimEngine(store, capacity=1 << 18, node_ip="10.0.0.1",
                       device=dev)
    props = LinkProperties(latency="10ms", rate="10Gbit")
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
    n_links = uid

    def mk(name, links):
        t = Topology(name=name, spec=TopologySpec(links=links))
        # placement known (CNI ran), links not yet realized
        t.status.src_ip, t.status.net_ns = "10.0.0.1", f"/run/netns/{name}"
        t.status.links = []
        store.create(t)

    for s in range(n_spine):
        mk(f"spine{s}", spines[s])
    for l in range(n_leaf):
        mk(f"leaf{l}", leaves[l])
    setup_s = time.perf_counter() - t0

    # kernel K1 built and loaded before timing: a steady-state controller
    # reconciles with warm kernels
    engine.warm_kernels()

    rec = Reconciler(store, engine)
    t0 = time.perf_counter()
    rec.drain(workers=workers)
    _sync(engine.state.device)  # includes the device flush
    realize_s = time.perf_counter() - t0
    assert engine.num_active == 2 * n_links, engine.num_active

    # churn: replace every link's properties through the spec
    new_props = LinkProperties(latency="20ms", jitter="1ms", rate="1Gbit")
    t0 = time.perf_counter()
    for t in store.list():
        t.spec.links = [l.with_properties(new_props) for l in t.spec.links]
        store.update(t)
    rec.drain(workers=workers)
    _sync(engine.state.device)
    churn_s = time.perf_counter() - t0

    # spot-check BEFORE the gRPC phase re-applies old props to spine0
    lat_col = es.PROP_NAMES.index("latency_us")
    churned = float(engine.state.props[0, lat_col])
    assert churned == 20_000.0, churned

    # gRPC surface: one live UpdateLinks round trip for a big batch
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    daemon = Daemon(engine)
    server, port = make_server(daemon, port=0, host="127.0.0.1")
    server.start()
    client = DaemonClient(f"127.0.0.1:{port}")
    batch = [pb.link_to_proto(l) for l in spines[0][:grpc_batch]]
    q = pb.LinksBatchQuery(
        local_pod=pb.Pod(name="spine0", kube_ns="default"),
        links=batch)
    client.UpdateLinks(q)  # warm the path once...
    engine.flush()         # ...including the small-batch device ops
    _sync(dev)
    t0 = time.perf_counter()
    resp = client.UpdateLinks(q)
    engine.flush()
    _sync(dev)
    grpc_update_s = time.perf_counter() - t0
    client.close()
    server.stop(0)

    # teardown: every pod destroyed through the real path (CNI cmdDel →
    # DestroyPod, reference handler.go:538-590) back to an empty fabric
    t0 = time.perf_counter()
    for t in store.list():
        engine.destroy_pod(t.name, t.namespace)
    engine.flush()
    _sync(dev)
    teardown_s = time.perf_counter() - t0
    assert engine.num_active == 0, engine.num_active

    return {
        "scenario": "reconcile_100k",
        "device": str(dev),
        "topologies": n_spine + n_leaf,
        "links": n_links,
        "directed_rows": 2 * n_links,
        "setup_s": round(setup_s, 3),
        "reconcile_s": round(realize_s, 3),
        "churn_s": round(churn_s, 3),
        "teardown_s": round(teardown_s, 3),
        "grpc_update_s": round(grpc_update_s, 4),
        "grpc_update_links": len(batch),
        "grpc_ok": bool(resp.response),
        "device_calls": engine.stats.device_calls,
        "spot_check_latency_us": churned,
        "target_s": 5.0,
        "meets_target": realize_s < 5.0,
    }


def scale_1m(n_spine: int = 200, n_leaf: int = 2500,
             links_per_pair: int = 2, update_iters: int = 10,
             shape_iters: int = 10, device=None, *, keep=None):
    """Rung 7: ONE MILLION links — 10× the BASELINE ladder's top rung.

    A 1M-link Clos loads into edge state as 2M directed rows (capacity
    2^21), then the two data-plane primitives run at full fabric width:
    a whole-fabric UpdateLinks each iteration (in place, the contiguous
    form) and one netem → TBF step over every active row each iteration
    (kernel K1 on the card, netem.shape_step_auto). Each timed loop runs
    once untimed first, as the JAX rung compiles and warms its scans.
    The shaping draws of iteration i come from a generator keyed by
    (9, i) (`_keyed_generator`), where the JAX rung folds i into
    key(9). With `keep` (a dict), the final EdgeState is left in it
    under "state" for a caller's own checks.
    """
    import numpy as np
    import torch

    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import netem

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.clos(n_spine, n_leaf, 0,
                props=LinkProperties(latency="10ms", rate="10Gbit"),
                links_per_pair=links_per_pair)
    L = el.n_links
    state, rows = T.load_edge_list_into_state(el, device=dev)
    _sync(dev)
    load_s = time.perf_counter() - t0

    uprops = torch.as_tensor(T.random_link_props(L, seed=5), device=dev)
    urows = np.arange(L, dtype=np.int32)  # every local end, one batch
    valid = torch.ones((L,), dtype=torch.bool, device=dev)

    def run_updates(st, iters):
        for _ in range(iters):
            st = es.update_links(st, urows, uprops, valid, True)
        return st

    state = run_updates(state, update_iters)  # warm
    _sync(dev)
    tb = time.perf_counter()
    state = run_updates(state, update_iters)
    _sync(dev)
    updates_per_s = L * update_iters / (time.perf_counter() - tb)

    E = state.capacity
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=dev)
    t_arr = torch.zeros((E,), dtype=torch.float32, device=dev)

    def run_shape(st, iters):
        for i in range(iters):
            st, _res = netem.shape_step_auto(
                st, sizes, st.active, t_arr, _keyed_generator(dev, 9, i))
        return st

    n_active = int(state.active.sum())
    state = run_shape(state, shape_iters)  # warm
    _sync(dev)
    tb = time.perf_counter()
    state = run_shape(state, shape_iters)
    _sync(dev)
    shape_pkts_per_s = n_active * shape_iters / (time.perf_counter() - tb)
    if keep is not None:
        keep["state"] = state

    return {
        "scenario": "scale_1m",
        "device": str(dev),
        "links": L,
        "directed_rows": 2 * L,
        "capacity": E,
        "load_s": round(load_s, 3),
        "updates_per_sec": round(updates_per_s, 1),
        "shape_pkts_per_sec": round(shape_pkts_per_s, 1),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def chaos_flaps(n_nodes: int = 500, n_links: int = 1500, events: int = 4,
                flaps_per_event: int = 10, steps_per_event: int = 30,
                dt_us: float = 1000.0, rate_bps: float = 2e6,
                seed: int = 3, device=None):
    """Rung 8: fault-injection chaos — random link flaps under live
    routed traffic.

    Per event, `flaps_per_event` random links go down (both directions),
    routes reconverge as one batched recompute, routed CBR traffic keeps
    flowing (each shaping slot one launch of K1 on the card), then the
    links come back and routes reconverge again. Reports per-event
    recompute times, delivery continuity and packets lost to dead
    routes. The links are 1 ms latency-only and the traffic CBR, so no
    outcome depends on a draw."""
    import numpy as np

    from kubedtn_tpu_torch import router as RT
    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.models.traffic import cbr_everywhere
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import routing as R

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.random_mesh(n_nodes, n_links, seed=seed,
                       props=LinkProperties(latency="1ms"))
    state, rows = T.load_edge_list_into_state(el, device=dev)
    n_dir = len(rows)
    _, nh = R.recompute_routes(state, n_nodes, max_hops=12)

    # slot budget sized to the offered load (generate() clamps emissions
    # to k_slots per step: too few would silently cap rate_bps)
    k_slots = min(8, max(2, int(np.ceil(rate_bps * dt_us / 8e6 / 1500.0))
                         + 1))
    k_fwd = 8
    rs = RT.init_router(state, nh, n_nodes, q=16, k_fwd=k_fwd)
    spec = cbr_everywhere(state.capacity, n_dir, rate_bps=rate_bps,
                          device=dev)
    # every edge-sourced flow targets a random far node: multi-hop load
    rng = np.random.default_rng(seed + 1)
    fdst = np.full((state.capacity,), -1, np.int32)
    fdst[:n_dir] = rng.integers(0, n_nodes, n_dir)

    # original (uid, src, dst, props) of each directed row, for restore
    src0, dst0, uid0, props0 = el.directed()
    phase = [0]

    def run(rs, steps):
        before_rx = float(rs.node_rx_packets.sum())
        before_tx = float(rs.sim.counters.tx_packets.sum())
        before_nr = float(rs.no_route_dropped)
        phase[0] += 1
        rs = RT.run_routed(rs, spec, fdst, steps=steps, dt_us=dt_us,
                           k_slots=k_slots, k_fwd=k_fwd,
                           seed=seed * 1000 + phase[0])
        return rs, {
            "tx": float(rs.sim.counters.tx_packets.sum()) - before_tx,
            "rx": float(rs.node_rx_packets.sum()) - before_rx,
            "no_route": float(rs.no_route_dropped) - before_nr,
        }

    def reroute(rs):
        _sync(dev)
        tb = time.perf_counter()
        _, nh = R.recompute_routes(rs.sim.edges, n_nodes, max_hops=12)
        _sync(dev)
        return dataclasses.replace(rs, next_edge=nh), \
            time.perf_counter() - tb

    rs, baseline = run(rs, steps_per_event)
    event_rows = []
    for _ in range(events):
        flap = rng.choice(el.n_links, flaps_per_event, replace=False)
        both = np.concatenate([flap, flap + el.n_links]).astype(np.int32)
        # in place on the state's edges, which the next steps read
        es.delete_links(rs.sim.edges, both, np.ones(len(both), bool))
        rs, down_recompute_s = reroute(rs)
        rs, down = run(rs, steps_per_event)

        # restore: re-apply the original rows, reconverge
        es.apply_links(rs.sim.edges, both, uid0[both], src0[both],
                       dst0[both], props0[both], np.ones(len(both), bool))
        rs, up_recompute_s = reroute(rs)
        rs, up = run(rs, steps_per_event)
        event_rows.append({
            "flapped_links": int(len(flap)),
            "down_recompute_s": round(down_recompute_s, 4),
            "up_recompute_s": round(up_recompute_s, 4),
            "rx_during_outage": down["rx"],
            "no_route_during_outage": down["no_route"],
            "rx_after_restore": up["rx"],
        })

    return {
        "scenario": "chaos_flaps",
        "device": str(dev),
        "nodes": n_nodes,
        "links": n_links,
        "events": events,
        "baseline_rx": baseline["rx"],
        "baseline_no_route": baseline["no_route"],
        "event_results": event_rows,
        "recompute_s_median": round(float(np.median(
            [e["down_recompute_s"] for e in event_rows])), 4),
        "traffic_survived_every_outage": all(
            e["rx_during_outage"] > 0 for e in event_rows),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def reconverge_10k(events: int = 4, seed: int = 0, dst_chunk: int = 1004,
                   pods: int = 100, leaves_per_pod: int = 96, device=None):
    """Flap reconvergence latency at the 10k-node rung: a three-tier DC
    fabric (models.topologies.three_tier — 10,040 nodes / 23,200 links
    at the default `pods` and `leaves_per_pod`), one link down per
    event, routes re-derived with the incremental delta path
    (ops.routing.update_routes_incremental) and verified against a
    converged full recompute on the first event; plus one 10-link flap
    processed as a single batched event (down and up), after a warm-up
    flap of other links. No shaping: no kernel of the port is
    launched."""
    import numpy as np
    import torch

    from kubedtn_tpu_torch.models import topologies as T
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import routing as R

    dev = resolve_device(device)
    t0 = time.perf_counter()
    el = T.three_tier(pods=pods, leaves_per_pod=leaves_per_pod, seed=seed)
    state, rows = T.load_edge_list_into_state(el, device=dev)
    n_nodes = el.n_nodes

    def full_exact(st):
        seed_d = torch.full((n_nodes, n_nodes), torch.inf,
                            dtype=torch.float32, device=dev)
        d = R.refine_dist(st, n_nodes, seed_d, 64, dst_chunk)
        return d, R.next_hop_edges(st, d, n_nodes, dst_chunk)

    def timed(fn, *args, **kwargs):
        _sync(dev)
        tb = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(dev)
        return out, time.perf_counter() - tb

    (dist, nh), initial_s = timed(full_exact, state)

    rng = np.random.default_rng(seed + 1)

    def event_edges(state, both):
        """(w_old, src, dst) of the directed rows `both`, on the host."""
        rows_t = torch.as_tensor(both, device=dev).long()
        return (R.edge_weights_latency(state)[rows_t].cpu().numpy(),
                state.src[rows_t].cpu().numpy(),
                state.dst[rows_t].cpu().numpy())

    event_rows = []
    full_s_ref = None
    agrees = None
    for ev in range(events):
        link = int(rng.integers(0, el.n_links))
        both = np.array([link, link + el.n_links], np.int32)
        w_old, s_k, d_k = event_edges(state, both)
        state = es.delete_links(state, both, np.ones(2, bool))
        if ev == 0:
            # one full recompute for the reference time + agreement check
            (dist_f, _), full_s_ref = timed(full_exact, state)
        (dist, nh, cells), inc_s = timed(
            R.update_routes_incremental, state, n_nodes, dist, nh, s_k,
            d_k, w_old, np.full(2, np.inf, np.float32),
            dst_chunk=dst_chunk)
        if ev == 0:
            agrees = bool(np.allclose(dist.cpu().numpy(),
                                      dist_f.cpu().numpy(), rtol=1e-5,
                                      atol=1e-1, equal_nan=True))
        event_rows.append({"link": link, "reconverge_s": round(inc_s, 3),
                           "cells": int(cells)})
    steady = [e["reconverge_s"] for e in event_rows[1:]] or \
        [event_rows[0]["reconverge_s"]]

    src0, dst0, uid0, props0 = el.directed()

    def flap_event(state, dist, nh):
        """One 10-link flap: delete all links (timed), restore all links
        (timed); returns the new state and tables, the timings and the
        cells. The warm-up and the measured flap run this same code."""
        links = rng.choice(el.n_links, 10, replace=False)
        both = np.concatenate([links, links + el.n_links]).astype(np.int32)
        inf = np.full(len(both), np.inf, np.float32)
        ones = np.ones(len(both), bool)
        w_old, s_k, d_k = event_edges(state, both)
        state = es.delete_links(state, both, ones)
        (dist, nh, cells_dn), down_s = timed(
            R.update_routes_incremental, state, n_nodes, dist, nh, s_k,
            d_k, w_old, inf, dst_chunk=dst_chunk)
        state = es.apply_links(state, both, uid0[both], src0[both],
                               dst0[both], props0[both], ones)
        w_new, _, _ = event_edges(state, both)
        (dist, nh, cells_up), up_s = timed(
            R.update_routes_incremental, state, n_nodes, dist, nh, s_k,
            d_k, inf, w_new, dst_chunk=dst_chunk)
        return state, dist, nh, down_s, up_s, cells_dn + cells_up

    state, dist, nh, _, _, _ = flap_event(state, dist, nh)  # warm-up
    state, dist, nh, flap10_down_s, flap10_up_s, flap10_cells = \
        flap_event(state, dist, nh)

    return {
        "scenario": "reconverge_10k",
        "device": str(dev),
        "nodes": n_nodes,
        "links": el.n_links,
        "initial_full_s": round(initial_s, 3),
        "full_recompute_s": round(full_s_ref, 3),
        "events": event_rows,
        "reconverge_s_steady": round(float(np.mean(steady)), 3),
        "speedup_vs_full": round(full_s_ref / float(np.mean(steady)), 1),
        "matches_full_recompute": agrees,
        "flap10_down_s": round(flap10_down_s, 3),
        "flap10_up_s": round(flap10_up_s, 3),
        "flap10_cells": int(flap10_cells),
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def _tenant_plane_setup(tenants: dict, latency: str, dt_us: float,
                        prefix: str, server: bool = False, device=None):
    """Multi-tenant plane harness: one namespace per tenant in
    `tenants` ({name: {"pairs": N, "qos": ..., "frame_budget_per_s":
    ..., "block_edges": ...}}), a TenantRegistry attached to engine +
    plane, telemetry on, the engine on `device` (None = the CUDA card).
    Returns (daemon, server_or_None, port, plane, registry, {tenant:
    (wires_in, wires_out)})."""
    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.tenancy import TenantRegistry
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon

    total_pairs = sum(t["pairs"] for t in tenants.values())
    store = TopologyStore()
    engine = SimEngine(store, capacity=4 * total_pairs + 8,
                       device=resolve_device(device))
    registry = TenantRegistry(engine)
    for name, cfg in tenants.items():
        registry.create(
            name, qos=cfg.get("qos"),
            frame_budget_per_s=cfg.get("frame_budget_per_s", 0.0),
            byte_budget_per_s=cfg.get("byte_budget_per_s", 0.0),
            block_edges=cfg.get("block_edges", 0))
    props = LinkProperties(latency=latency)
    uid = 0
    for ns, cfg in tenants.items():
        for i in range(cfg["pairs"]):
            uid += 1
            a, b = f"{prefix}-{ns}-a{i}", f"{prefix}-{ns}-b{i}"
            store.create(Topology(name=a, namespace=ns,
                                  spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1", peer_pod=b,
                     uid=uid, properties=props)])))
            store.create(Topology(name=b, namespace=ns,
                                  spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1", peer_pod=a,
                     uid=uid, properties=props)])))
            engine.setup_pod(a, ns)
            engine.setup_pod(b, ns)
    Reconciler(store, engine).drain()
    daemon = Daemon(engine)
    srv = port = None
    if server:
        from kubedtn_tpu_torch.wire.server import make_server

        srv, port = make_server(daemon, port=0, host="127.0.0.1",
                                log_rpcs=False)
        srv.start()
    plane = WireDataPlane(daemon, dt_us=dt_us)
    plane.pipeline_explicit_clock = True
    plane.attach_tenancy(registry)
    plane.enable_telemetry(window_s=0.5, sample_period=256)
    wires: dict = {}
    uid = 0
    for ns, cfg in tenants.items():
        win, wout = [], []
        for i in range(cfg["pairs"]):
            uid += 1
            win.append(daemon._add_wire(wire_def(
                f"{prefix}-{ns}-a{i}", ns, uid)))
            wout.append(daemon._add_wire(wire_def(
                f"{prefix}-{ns}-b{i}", ns, uid)))
        wires[ns] = (win, wout)
    return daemon, srv, port, plane, registry, wires


def burn_recovery(pairs: int = 2, loss_pct: float = 25.0,
                  feed_per_tick: int = 40, dt_us: float = 1000.0,
                  latency: str = "2ms", tick_step_s: float = 0.05,
                  seed: int = 0, width: int = 2, steps: int = 200,
                  max_polls: int = 60, post_ticks: int = 20,
                  device=None):
    """SLO-autopilot chaos scenario: the WHOLE closed loop on one live
    plane — inject loss on a gold tenant's a-side edges until the
    fast-burn pages, then let the autopilot search (ONE batched twin
    sweep on the tenant's snapshot fork), gate, and stage the winning
    delta, and verify the burn clears with ZERO frame loss after the
    cutover. The plane's engine lies on `device` (None = the CUDA
    card).

    The plane runs on the explicit tick clock (deterministic: frames
    fed per tick, virtual seconds per tick) with the autopilot's
    stager driven by the same clock (`tick_driver`), so the record is
    reproducible tick-for-tick. The fault goes in through the
    CANONICAL control path — mutate `topo.spec.links`, store.update,
    reconciler drain — so `status.links` reflects the paged
    properties the candidate generator reads.

    Acceptance (the `in_guardrails` bit): the page fired, exactly one
    remediation staged (compile/run split recorded), severity left
    `page`, and the post-cutover feed was delivered in full —
    `post_frames_lost == 0` — with zero tick errors."""
    from kubedtn_tpu_torch.autopilot import Autopilot, AutopilotConfig
    from kubedtn_tpu_torch.slo import SloEvaluator
    from kubedtn_tpu_torch.topology.reconciler import Reconciler

    t0 = time.perf_counter()
    cfg = {"t0": {"pairs": pairs, "qos": "gold"}}
    daemon, _srv, _port, plane, registry, wires = _tenant_plane_setup(
        cfg, latency, dt_us, "burnrec", device=device)
    engine = plane.engine
    store = engine.store
    rec = Reconciler(store, engine)
    win, wout = wires["t0"]
    frame = b"\xab" * 200
    clock = [100.0]
    fed = [0]
    delivered = [0]

    def ticks(n: int, feed: int = 0) -> None:
        for _ in range(n):
            if feed:
                for w in win:
                    w.ingress.extend([frame] * feed)
                fed[0] += feed * len(win)
            clock[0] += tick_step_s
            plane.tick(now_s=clock[0])
            for w in wout:
                while True:
                    try:
                        w.egress.popleft()
                    except IndexError:
                        break
                    delivered[0] += 1

    ev = SloEvaluator(registry, plane)
    ap = Autopilot(registry, plane, ev,
                   config=AutopilotConfig(seed=seed, width=width,
                                          steps=steps, dt_us=dt_us,
                                          page_polls=1, cooldown_s=5.0,
                                          verify_polls=20),
                   tick_driver=lambda n: ticks(n))
    ap.enable()

    # warm: a healthy baseline the evaluator has seen
    ticks(10, feed=feed_per_tick)
    ev.maybe_evaluate()
    warm = ev.verdicts().get("t0")
    warm_severity = warm.severity if warm else ""

    # fault injection through the canonical path (spec -> reconcile,
    # status copy-back included): loss on every a-side edge
    loss = f"{loss_pct:g}"
    for topo in store.list("t0"):
        if "-a" not in topo.name:
            continue
        fresh = store.get(topo.namespace, topo.name)
        fresh.spec.links = [
            l.with_properties(dataclasses.replace(l.properties, loss=loss))
            for l in fresh.spec.links]
        store.update(fresh)
    rec.drain()

    paged = False
    page_fast_burn = 0.0
    staged = None
    polls_to_green = -1
    for i in range(max_polls):
        ticks(5, feed=feed_per_tick)
        ev.maybe_evaluate()
        v = ev.verdicts().get("t0")
        if v is not None and v.severity == "page" and not paged:
            paged = True
            page_fast_burn = v.fast_burn
        for a in ap.poll():
            if a.get("verdict") == "staged":
                staged = a
        if staged and v is not None and v.severity != "page":
            polls_to_green = i
            break

    # drain in-flight, then the post-cutover accounting phase: every
    # frame fed after the staged delta must come out the other end
    ticks(40)
    c0 = registry.tenant_counters(plane, "t0")
    fed_before, delivered_before = fed[0], delivered[0]
    ticks(post_ticks, feed=feed_per_tick)
    ticks(40)
    c1 = registry.tenant_counters(plane, "t0")
    post_fed = fed[0] - fed_before
    post_delivered = delivered[0] - delivered_before
    post_dropped = sum(
        c1[k] - c0[k]
        for k in ("dropped_loss", "dropped_queue", "dropped_ring"))
    ev.maybe_evaluate()
    final = ev.verdicts().get("t0")
    st = ap.status()
    snap = st["stats"]
    la = ap.last_action("t0") or {}
    recovered = bool(final is not None and final.severity != "page")
    ok = (paged and staged is not None and recovered
          and post_fed > 0 and post_dropped == 0
          and post_delivered == post_fed
          and plane.tick_errors == 0)
    out = {
        "scenario": "burn_recovery",
        "pairs": pairs,
        "loss_pct": loss_pct,
        "warm_severity": warm_severity,
        "paged": paged,
        "page_fast_burn": round(page_fast_burn, 3),
        "searches_run": snap["searches_run"],
        "candidates_evaluated": snap["candidates_evaluated"],
        "sweep_compile_s": round(snap["sweep_compile_s"], 3),
        "sweep_run_s": round(snap["sweep_run_s"], 3),
        "staged": staged is not None,
        "staged_candidate": (staged or {}).get("candidate", ""),
        "staged_kind": (staged or {}).get("kind", ""),
        "plans_staged": (staged or {}).get("plans", 0),
        "deltas_rolled_back": snap["deltas_rolled_back"],
        "polls_to_green": polls_to_green,
        "time_to_green_s": round(
            float(la.get("time_to_green_s", 0.0)), 3),
        "recovered_severity": final.severity if final else "",
        "post_frames_fed": post_fed,
        "post_frames_delivered": post_delivered,
        "post_frames_lost": post_dropped,
        "frames_fed_total": fed[0],
        "frames_delivered_total": delivered[0],
        "tick_errors": plane.tick_errors,
        "in_guardrails": ok,
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    ap.stop()
    ev.stop()
    plane.stop()
    return out


# non-IP ethertype: never eligible for the TCP bypass, so every frame
# crosses the shaping plane and the loss accounting is exact
_FAULT_FRAME = b"\x02" * 12 + b"\x07\x77" + b"\x00" * 50


def _drain_wires(wires_out) -> int:
    """Pop everything delivered so far; returns the count."""
    c = 0
    for w in wires_out:
        dq = w.egress
        while True:
            try:
                dq.popleft()
            except IndexError:
                break
            c += 1
    return c


def _paced_feeder(wires_in, offered_frames_per_s: int, stop, fed,
                  frame: bytes = _FAULT_FRAME, pace_s: float = 0.02):
    """Fixed chunk per wire every pace_s keeps the offered load below
    plane capacity, so loss accounting is exact (every fed frame must
    eventually arrive). Run as a thread body; `fed` is a 1-list."""
    per_wire = max(1, int(offered_frames_per_s * pace_s
                          / max(len(wires_in), 1)))
    chunk = [frame] * per_wire
    while not stop.is_set():
        for w in wires_in:
            w.ingress.extend(chunk)
        fed[0] += per_wire * len(wires_in)
        stop.wait(pace_s)


def _warm_live_load(wires_in, drain, fed, per_wire: int, label: str,
                    frame: bytes = _FAULT_FRAME,
                    timeout_s: float = 120.0) -> int:
    """Chaos-free warm phase: one chunk end-to-end builds the kernels
    and settles the stream, so the measured windows see the plane.
    Returns frames delivered (== fed)."""
    for w in wires_in:
        w.ingress.extend([frame] * per_wire)
    fed[0] += per_wire * len(wires_in)
    delivered = 0
    deadline = time.monotonic() + timeout_s
    while delivered < fed[0] and time.monotonic() < deadline:
        time.sleep(0.02)
        delivered += drain()
    if delivered < fed[0]:
        raise RuntimeError(f"{label} warm-up never delivered "
                           f"({delivered}/{fed[0]})")
    return delivered


def migration_under_flap(pairs: int = 2, seconds: float = 6.0,
                         migrate_after_s: float = 1.5,
                         flap_period_s: float = 1.0,
                         duty_down: float = 0.4,
                         offered_frames_per_s: int = 4_000,
                         latency: str = "2ms", dt_us: float = 2_000.0,
                         seed: int = 11,
                         reconcile_timeout_s: float = 30.0,
                         drain_timeout_s: float = 60.0, device=None):
    """Live tenant migration LANDING MID-FLAP, end to end: two real
    gRPC daemons each running a plane on `device` (None = the CUDA
    card) — A (src) shapes the tenant's cross-node links and forwards to
    B (dst) through a per-peer sender whose breaker the chaos injector
    keeps cycling — and the federation state machine moves the tenant
    A→B while the paced load keeps flowing. The migration must COMPLETE
    (or roll back cleanly) with:

    - frames_lost == 0 — every fed frame arrives exactly once, whether
      it was shaped on A (riding the flapping peer's outage buffer to
      B) or transferred at cutover and shaped on B directly;
    - byte-exact accounting — fed == delivered_src + delivered_dst
      (the links are lossless), with the telemetry window-ring totals
      agreeing with the counter slices on both planes and
      `kubedtn_migration_accounting_mismatch` == 0;
    - RECONCILE breaker-aware — an open A→B breaker parks the outage
      buffer mid-migration; the drain must wait it out, never fail the
      migration or drop the buffer.

    Self-verdicting (`in_guardrails`)."""
    import tempfile
    import threading as _threading

    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec
    from kubedtn_tpu_torch.chaos import ChaosInjector
    from kubedtn_tpu_torch.federation import (FederationController,
                                              MigrationError,
                                              MigrationStats, PlaneHandle)
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.tenancy import TenantRegistry
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    t0 = time.perf_counter()
    dev = resolve_device(device)

    def make_node():
        store = TopologyStore()
        engine = SimEngine(store, capacity=4 * pairs + 8, device=dev)
        daemon = Daemon(engine)
        server, port = make_server(daemon, port=0, host="127.0.0.1",
                                   log_rpcs=False)
        server.start()
        addr = f"127.0.0.1:{port}"
        engine.node_ip = addr
        registry = TenantRegistry(engine)
        plane = WireDataPlane(daemon, dt_us=dt_us)
        plane.attach_tenancy(registry)
        # ring sized to cover the whole run, so the window-ring totals
        # reconcile against the cumulative counters byte-exactly
        plane.enable_telemetry(window_s=0.5, windows=256,
                               sample_period=64, node=addr)
        return store, engine, daemon, server, addr, registry, plane

    (store_a, engine_a, daemon_a, server_a, addr_a, reg_a,
     plane_a) = make_node()
    (store_b, engine_b, daemon_b, server_b, addr_b, reg_b,
     plane_b) = make_node()
    props = LinkProperties(latency=latency)
    for store in (store_a, store_b):
        for i in range(pairs):
            ta = Topology(name=f"ma{i}", spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1",
                     peer_pod=f"mb{i}", uid=i + 1, properties=props)]))
            tb = Topology(name=f"mb{i}", spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1",
                     peer_pod=f"ma{i}", uid=i + 1, properties=props)]))
            ta.status.src_ip, ta.status.net_ns = addr_a, "/ns/a"
            tb.status.src_ip, tb.status.net_ns = addr_b, "/ns/b"
            store.create(ta)
            store.create(tb)
    for i in range(pairs):
        t = store_a.get("default", f"ma{i}")
        if not engine_a.add_links(t, t.spec.links):
            raise RuntimeError("cross-node realize failed")
    reg_a.create("mig", namespaces=["default"])
    wires_in, wires_out = [], []
    for i in range(pairs):
        wb = daemon_b._add_wire(types.SimpleNamespace(
            **{**vars(wire_def(f"mb{i}", "default", i + 1)),
               "peer_ip": addr_a}))
        wa = daemon_a._add_wire(types.SimpleNamespace(
            **{**vars(wire_def(f"ma{i}", "default", i + 1)),
               "peer_ip": addr_b, "peer_intf_id": wb.wire_id}))
        wires_in.append(wa)
        wires_out.append(wb)

    stats = MigrationStats()
    chaos = ChaosInjector(seed=seed)
    fed = FederationController(tempfile.mkdtemp(prefix="kdt-mig-"),
                               stats=stats)
    fed.register(PlaneHandle("A", daemon_a, plane_a, reg_a))
    fed.register(PlaneHandle("B", daemon_b, plane_b, reg_b))
    plane_a.attach_chaos(chaos)
    plane_a.start()
    plane_b.start()

    fed_count = [0]
    stop_feed = _threading.Event()

    def drain_delivered() -> int:
        # pre-cutover path lands on B's mb wires (forwarded by A);
        # post-cutover the ma rows shape ON B and deliver to B's
        # (now-local) ma wires — count both
        got = _drain_wires(wires_out)
        for i in range(pairs):
            w = daemon_b.wires.get_by_key(f"default/ma{i}", i + 1)
            if w is not None and w.egress:
                got += _drain_wires([w])
        return got

    delivered = 0
    outcome = "completed"
    rec = None
    acct = None
    try:
        delivered = _warm_live_load(
            wires_in, drain_delivered, fed_count,
            max(1, int(offered_frames_per_s * 0.02 / pairs)),
            "migration_under_flap")
        feed = _threading.Thread(
            target=_paced_feeder,
            args=(wires_in, offered_frames_per_s, stop_feed, fed_count),
            daemon=True)
        feed.start()
        chaos.flap_peer(addr_b, flap_period_s, duty_down)
        time.sleep(migrate_after_s)
        try:
            rec = fed.migrate("mig", "A", "B",
                              reconcile_timeout_s=reconcile_timeout_s)
        except MigrationError:
            co = fed.coordinator(fed.status(tenant="mig")[-1]
                                 ["migration_id"])
            if "cutover" in co.record()["steps_done"]:
                rec = co.resume()
            else:
                rec = co.rollback()
                outcome = "rolled_back"
        t_end = time.monotonic() + max(0.0, seconds - migrate_after_s)
        while time.monotonic() < t_end:
            time.sleep(0.1)
            delivered += drain_delivered()
        stop_feed.set()
        feed.join(timeout=5)
        chaos.heal_peer(addr_b)
        deadline = time.monotonic() + drain_timeout_s
        while delivered < fed_count[0] and time.monotonic() < deadline:
            time.sleep(0.05)
            delivered += drain_delivered()
        plane_a.flush_peers(timeout_s=10.0)
        plane_b.flush_peers(timeout_s=10.0)
        delivered += drain_delivered()
        if outcome == "completed" and rec is not None:
            acct = fed.coordinator(
                rec["migration_id"]).check_accounting(fed_count[0])
    finally:
        stop_feed.set()
        pstats = plane_a.peer_fault_stats().get(addr_b, {})
        plane_a.stop()
        plane_b.stop()
        server_a.stop(0)
        server_b.stop(0)
    # window-ring totals must agree with the counter slices: src side
    # frozen in the reconcile record, dst side live at the end
    ring_ok = True
    if outcome == "completed" and rec is not None:
        rc = rec if "reconcile" in rec else fed.coordinator(
            rec["migration_id"]).record()
        rcn = rc.get("reconcile", {})
        win_src = rcn.get("window_src") or {}
        ring_ok = (abs(win_src.get("delivered", 0.0)
                       - rcn.get("counters_src", {})
                       .get("delivered_packets", 0.0)) < 0.5)
        win_dst = reg_b.tenant_window(plane_b, "mig")
        cnt_dst = reg_b.tenant_counters(plane_b, "mig")
        ring_ok = ring_ok and (abs(
            win_dst.get("delivered", 0.0)
            - cnt_dst["delivered_packets"]) < 0.5)
    frames_lost = fed_count[0] - delivered
    mismatch = (acct or {}).get(
        "mismatch", 0.0 if outcome == "rolled_back" else None)
    snap = stats.snapshot()
    in_guardrails = (frames_lost == 0 and ring_ok
                     and (mismatch == 0.0 or mismatch is None)
                     and plane_a.tick_errors == 0
                     and plane_b.tick_errors == 0
                     and snap["accounting_mismatch"] == 0.0)
    return {
        "scenario": "migration_under_flap",
        "device": str(dev),
        "pairs": pairs,
        "seconds": seconds,
        "flap_hz": round(1.0 / flap_period_s, 3),
        "duty_down": duty_down,
        "offered_frames_per_s": offered_frames_per_s,
        "outcome": outcome,
        "steps_done": list((rec or {}).get("steps_done", ())),
        "resumed": int((rec or {}).get("resumed", 0)),
        "frames_fed": fed_count[0],
        "frames_delivered": delivered,
        "frames_lost": frames_lost,
        "transferred_frames": int(((rec or {}).get("cutover") or {})
                                  .get("transferred_frames", 0)),
        "accounting": acct,
        "accounting_mismatch_gauge": snap["accounting_mismatch"],
        "ring_totals_agree": ring_ok,
        "step_seconds": {k: round(v, 4) for k, v in
                         snap["step_seconds"].items()},
        "breaker": pstats,
        "breaker_cycles": int(pstats.get("cycles", 0)),
        "injected_faults": dict(chaos.injected),
        "tick_errors": plane_a.tick_errors + plane_b.tick_errors,
        "in_guardrails": in_guardrails,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def _fleet_node(tenants: dict, addr_port, latency: str, dt_us: float,
                pairs: int, seed: int = 0, capacity: int = 128,
                device=None):
    """One fleet member: store/engine/registry/daemon/plane + a real
    gRPC server, explicit-clock plane (the failover scenarios drive
    lockstep ticks so the kill/restart instants are exact), the engine on
    `device` (None = the CUDA card). `tenants` maps tenant name → base
    uid offset."""
    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.tenancy import TenantRegistry
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon

    store = TopologyStore()
    engine = SimEngine(store, capacity=capacity,
                       device=resolve_device(device))
    daemon = Daemon(engine)
    server, port = serve_on(daemon, addr_port)
    addr = f"127.0.0.1:{port}"
    engine.node_ip = addr
    registry = TenantRegistry(engine)
    plane = WireDataPlane(daemon, dt_us=dt_us, seed=seed)
    plane.pipeline_explicit_clock = True
    plane.attach_tenancy(registry)
    props = LinkProperties(latency=latency)
    for ns, base in tenants.items():
        registry.create(ns)
        for i in range(pairs):
            uid = base + i + 1
            a, b = f"{ns}-a{i}", f"{ns}-b{i}"
            for name, peer in ((a, b), (b, a)):
                t = Topology(name=name, namespace=ns,
                             spec=TopologySpec(links=[
                                 Link(local_intf="eth1",
                                      peer_intf="eth1", peer_pod=peer,
                                      uid=uid, properties=props)]))
                store.create(t)
                engine.setup_pod(name, ns)
    Reconciler(store, engine).drain()
    for ns, base in tenants.items():
        for i in range(pairs):
            uid = base + i + 1
            for side in ("a", "b"):
                daemon._add_wire(wire_def(f"{ns}-{side}{i}", ns, uid))
    return {"store": store, "engine": engine, "daemon": daemon,
            "plane": plane, "registry": registry, "server": server,
            "addr": addr}


def serve_on(daemon, port: int = 0, host: str = "127.0.0.1",
             tries: int = 100):
    """A started gRPC server for `daemon` (`port` 0 = pick one). A port a
    stopped server just released may take a moment to bind again: retry
    every 0.1 s. Returns (server, bound port)."""
    from kubedtn_tpu_torch.wire.server import make_server

    for _ in range(tries):
        try:
            server, bound = make_server(daemon, port=port, host=host,
                                        log_rpcs=False)
        except RuntimeError:   # grpc raises on a busy port
            server, bound = None, 0
        if bound:
            server.start()
            return server, bound
        time.sleep(0.1)
    raise RuntimeError(f"port {port} rebind failed")


def gated_offer(nodes: dict, order, key: tuple, frames: list) -> bool:
    """Offer `frames` on the wire `key` = (pod_key, uid) of the first
    node in `order` whose accept gate is open and which realizes the
    link — a retrying producer's view of a fleet under upgrade. The gate
    is the in-process stand-in for the TCP listener: an append either
    lands before the restarter's capture (checkpointed) or is refused
    (the producer tries elsewhere), never dropped in between. True when
    the frames were accepted."""
    for name in order:
        node = nodes[name]
        with node["gate"]:
            if node["draining"]:
                continue
            if node["engine"].row_of(*key) is None:
                continue
            w = node["daemon"].wires.get_by_key(*key)
            if w is None:
                continue
            w.ingress.extend(frames)
            return True
    return False


def gated_producer(nodes: dict, order, keys, frames: list, fed: list,
                   stop, pace_s: float = 0.02) -> None:
    """Thread body: every `pace_s` until `stop` is set, `gated_offer`
    `frames` on each wire of `keys`; fed[0] counts the accepted frames
    (the loss denominator)."""
    while not stop.is_set():
        for key in keys:
            if gated_offer(nodes, order, key, frames):
                fed[0] += len(frames)
        stop.wait(pace_s)


def restart_node(node: dict, ckpt_dir: str, device, port: int, drain, *,
                 plane_kwargs: dict, live_save: bool = False,
                 configure=None, **restore_kw) -> tuple[dict, dict]:
    """A rolling upgrade's restart of one fleet node ("the new binary"):
    close its accept gate, checkpoint, tear down (server, plane;
    `drain(node)` hands the stopped node's delivered egress to the
    consumer), rebuild through `entry.restore_daemon`, attach a
    TenantRegistry when the checkpoint had none, `configure(plane)`,
    serve on the SAME port (the fleet's address book survives the
    upgrade), start the runner and warm the kernels before the first
    tick needs them.
    `live_save` checkpoints with `save_live` before the teardown (a plane
    the upgrade has already drained), else with `save` after it.
    Returns (restore_daemon's dict with `tenancy`, `server`, the old
    `gate` and `draining` False; seconds of each step)."""
    from kubedtn_tpu_torch import checkpoint, entry
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    steps = {}
    with node["gate"]:
        node["draining"] = True
    if live_save:
        t = time.perf_counter()
        checkpoint.save_live(ckpt_dir, node["store"], node["engine"],
                             node["plane"])
        steps["save_s"] = time.perf_counter() - t
    node["server"].stop(0)
    node["plane"].stop()
    drain(node)
    if not live_save:
        t = time.perf_counter()
        checkpoint.save(ckpt_dir, node["store"], node["engine"],
                        dataplane=node["plane"])
        steps["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    r = entry.restore_daemon(ckpt_dir, device, plane_kwargs=plane_kwargs,
                             **restore_kw)
    steps["restore_daemon_s"] = time.perf_counter() - t
    if r["tenancy"] is None:
        r["tenancy"] = TenantRegistry(r["engine"])
        r["plane"].attach_tenancy(r["tenancy"])
    if configure is not None:
        configure(r["plane"])
    r["server"], _port = serve_on(r["daemon"], port)
    r["plane"].start()
    t = time.perf_counter()
    r["engine"].warm_kernels()   # waits for the card
    steps["warm_kernels_s"] = time.perf_counter() - t
    r.update(gate=node["gate"], draining=False)
    return r, steps


def plane_failover(pairs: int = 2, warm_ticks: int = 30,
                   gap_frames_per_wire: int = 5,
                   frames_per_tick: int = 3, latency: str = "2ms",
                   dt_us: float = 2_000.0, seed: int = 7, device=None):
    """SIGKILL a loaded plane MID-MIGRATION; the fleet supervisor
    evacuates with NO operator action — the failover acceptance
    scenario, the planes' engines on `device` (None = the CUDA card):

    - two real gRPC daemons A (tenant `vic` + `bga`) and B (`bgb`),
      lockstep explicit-clock ticks, real Local.Health probes over the
      wire (`grpc_probe`) so the kill is detected as genuine dial
      failures;
    - steady load drains to idle, a crash-consistent `save_live`
      checkpoint lands (the periodic-autosave stand-in), then a
      migration of `vic` A→B is interrupted by an injected crash at
      RESTORE (journal holds a `running` record with the FORK
      committed);
    - `gap_frames_per_wire` more frames load A's ingress and A is
      killed (`kill -9` stand-in: no flush, no checkpoint, server
      down);
    - supervisor sweeps: healthy → suspect → dead (hysteresis), then
      evacuates automatically — the journal FORK (newest
      crash-consistent capture) rolls the tenant forward onto B, the
      background tenant comes from A's checkpoint;
    - feed resumes on B; the verdict pins the failover accounting
      EXACT: fed == delivered_src + delivered_dst + reported_lost
      with reported_lost exactly the post-checkpoint gap frames,
      `kubedtn_migration_accounting_mismatch` == 0, and the restored
      rows byte-identical to the fork capture."""
    import shutil
    import tempfile

    import numpy as np

    from kubedtn_tpu_torch import checkpoint
    from kubedtn_tpu_torch.chaos import ChaosError, ChaosInjector
    from kubedtn_tpu_torch.federation import (FederationController,
                                              FleetSupervisor,
                                              MigrationStats, PlaneHandle,
                                              grpc_probe)
    from kubedtn_tpu_torch.federation import journal as fjournal

    t0 = time.perf_counter()
    A = _fleet_node({"vic": 0, "bga": pairs}, 0, latency, dt_us, pairs,
                    seed=seed, device=device)
    B = _fleet_node({"bgb": 2 * pairs}, 0, latency, dt_us, pairs,
                    seed=seed, device=device)
    root = tempfile.mkdtemp(prefix="kdt-failover-")
    ck_a = f"{root}/ckA"
    mstats = MigrationStats()
    chaos = ChaosInjector(seed=seed)
    fed = FederationController(f"{root}/journal", stats=mstats,
                               chaos=chaos)
    fed.register(PlaneHandle("A", A["daemon"], A["plane"],
                             A["registry"], checkpoint_dir=ck_a,
                             probe=grpc_probe(A["addr"])))
    fed.register(PlaneHandle("B", B["daemon"], B["plane"],
                             B["registry"],
                             probe=grpc_probe(B["addr"])))
    sup = FleetSupervisor(fed, f"{root}/ledger", chaos=chaos,
                          suspect_after=2, dead_after=4,
                          healthy_after=2).attach()

    k = [0]
    fed_vic = [0]
    delivered = [0]

    def wire_of(node, ns, side, i, base):
        return node["daemon"].wires.get_by_key(f"{ns}/{ns}-{side}{i}",
                                               base + i + 1)

    def tick(feed_on=None):
        k[0] += 1
        t = 100.0 + k[0] * dt_us / 1e6
        if feed_on is not None:
            for i in range(pairs):
                w = wire_of(feed_on, "vic", "a", i, 0)
                for _ in range(frames_per_tick):
                    w.ingress.append(b"V" * 64)
                fed_vic[0] += frames_per_tick
        # background tenants keep both planes dispatching every tick
        for node, ns, base in ((A, "bga", pairs), (B, "bgb", 2 * pairs)):
            if getattr(node["daemon"], "chaos_dead", False):
                continue
            for i in range(pairs):
                w = wire_of(node, ns, "a", i, base)
                if w is not None:
                    w.ingress.append(b"G" * 64)
        for node in (A, B):
            if not getattr(node["daemon"], "chaos_dead", False):
                node["plane"].tick(now_s=t)

    def drain():
        for node in (A, B):
            for i in range(pairs):
                w = wire_of(node, "vic", "b", i, 0)
                if w is None:
                    continue
                while True:
                    try:
                        w.egress.popleft()
                        delivered[0] += 1
                    except IndexError:
                        break

    def settle_drain(n):
        for _ in range(n):
            tick()
        drain()

    outcome = {}
    try:
        # steady load, then drain to idle (the checkpoint is a clean
        # cut: no in-flight vic frames, counters == delivered)
        for _ in range(warm_ticks):
            tick(feed_on=A)
        settle_drain(warm_ticks)
        A["plane"].flush()
        k[0] += 5000
        settle_drain(1)
        delivered_before = delivered[0]
        # the periodic autosave (the RPO anchor)
        checkpoint.save_live(ck_a, A["store"], A["engine"], A["plane"])
        # mid-migration: crash injected at RESTORE — the journal keeps
        # a running record with the FORK committed
        chaos.fail_migration_step("restore")
        migration_crashed = False
        try:
            fed.migrate("vic", "A", "B", settle=tick)
        except ChaosError:
            migration_crashed = True
        # load the plane (the post-checkpoint gap), then kill -9
        gap = 0
        for i in range(pairs):
            w = wire_of(A, "vic", "a", i, 0)
            for _ in range(gap_frames_per_wire):
                w.ingress.append(b"L" * 64)
                gap += 1
        fed_vic[0] += gap
        chaos.kill_plane(fed.handle("A"), server=A["server"])
        # supervision: probes fail over the REAL wire, hysteresis
        # steps healthy → suspect → dead, evacuation is automatic
        sweeps = 0
        while sweeps < 20:
            sweeps += 1
            tr = sup.sweep()
            if tr.get("A") == "dead":
                break
        evac = sup.evacuations()[-1] if sup.evacuations() else {}
        vic_entry = (evac.get("tenants") or {}).get("vic", {})
        # fork byte-identity: the restored rows carry the capture's
        # exact bits (lockstep clocks ⇒ rebase delta 0)
        rows_identical = True
        if vic_entry.get("survivor") == "B":
            mid = fed.status(tenant="vic")[-1]["migration_id"]
            rec_full, arrays = fjournal.load_record(f"{root}/journal",
                                                    mid)
            fork = rec_full["fork"]
            eng_b = B["engine"]
            st_b = eng_b.state
            for n_i, (pk, uid, *_r) in enumerate(fork["identities"]):
                row = eng_b._rows.get((pk, int(uid)))
                if row is None:
                    rows_identical = False
                    break
                for col in ("tokens", "t_last", "corr", "pkt_count",
                            "backlog_until", "props"):
                    a = getattr(st_b, col)[row].cpu().numpy()
                    b = np.asarray(arrays[col])[n_i]
                    if not np.array_equal(a, b):
                        rows_identical = False
        # feed resumes on the survivor with NO operator action
        for _ in range(warm_ticks):
            tick(feed_on=B)
        settle_drain(warm_ticks)
        B["plane"].flush()
        k[0] += 5000
        settle_drain(1)
        acct = sup.check_failover_accounting("vic", fed_vic[0])
        snap = mstats.snapshot()
        fstats = sup.stats.snapshot()
        in_guardrails = (
            vic_entry.get("survivor") == "B"
            and vic_entry.get("source") == "journal-fork"
            and migration_crashed
            and rows_identical
            and acct["mismatch"] == 0.0
            and acct["reported_lost"] == gap
            and fed_vic[0] == acct["delivered_src"]
            + acct["delivered_dst"] + acct["reported_lost"]
            and delivered[0] == acct["delivered_src"]
            + acct["delivered_dst"]
            and snap["accounting_mismatch"] == 0.0
            and B["plane"].tick_errors == 0)
        outcome = {
            "scenario": "plane_failover",
            "pairs": pairs,
            "fed": fed_vic[0],
            "delivered": delivered[0],
            "delivered_before_kill": delivered_before,
            "gap_frames": gap,
            "sweeps_to_dead": sweeps,
            "evacuation": {
                "survivor": vic_entry.get("survivor"),
                "source": vic_entry.get("source"),
                "rows": vic_entry.get("rows"),
                "migrations_resolved": [
                    m["action"] for m in
                    evac.get("migrations_resolved", ())],
            },
            "restored_rows_byte_identical": rows_identical,
            "accounting": acct,
            "accounting_mismatch_gauge": snap["accounting_mismatch"],
            "reported_lost_gauge": fstats["reported_lost"],
            "transitions": fstats["transitions"],
            "in_guardrails": in_guardrails,
            "wall_s": round(time.perf_counter() - t0, 3),
        }
    finally:
        for node in (A, B):
            try:
                node["server"].stop(0)
            except Exception:
                pass
        shutil.rmtree(root, ignore_errors=True)
    return outcome


def fleet_rolling_upgrade(pairs: int = 1, steady_s: float = 1.5,
                          offered_frames_per_s: int = 2_000,
                          latency: str = "1ms", dt_us: float = 2_000.0,
                          seed: int = 3,
                          drain_timeout_s: float = 60.0, device=None):
    """`kdt fleet upgrade` end to end across TWO real gRPC daemons
    with live runners, the planes' engines on `device` (None = the CUDA
    card): the supervisor cordons each plane in turn, drains its tenants
    to the other plane via zero-loss live migrations, restarts the
    daemon (graceful checkpoint → full teardown → `entry.restore_daemon`
    from the checkpoint → new server on the SAME port), health-verifies
    over the real wire before refilling, then moves to the next plane —
    while a retrying producer keeps offering load the whole time.
    Verdict: zero frame loss for every accepted frame (fed ==
    delivered), both planes restarted and health-verified,
    `kubedtn_migration_accounting_mismatch` == 0."""
    import shutil
    import tempfile
    import threading as _threading

    from kubedtn_tpu_torch.federation import (FederationController,
                                              FleetSupervisor,
                                              MigrationStats, PlaneHandle,
                                              grpc_probe)

    t0 = time.perf_counter()
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="kdt-upgrade-")
    nodes: dict[str, dict] = {}
    TEN = {"A": ("ta", 0), "B": ("tb", pairs)}

    def build(name, port=0):
        node = _fleet_node({TEN[name][0]: TEN[name][1]}, port, latency,
                           dt_us, pairs, seed=seed, device=dev)
        node["plane"].pipeline_explicit_clock = False
        node["draining"] = False
        # accept gate: the in-process stand-in for the TCP listener —
        # a producer's append either lands before the teardown capture
        # (checkpointed) or is refused (producer retries elsewhere),
        # never silently dropped in between
        node["gate"] = _threading.Lock()
        nodes[name] = node
        return node

    for name in ("A", "B"):
        build(name)
        nodes[name]["plane"].start()
    mstats = MigrationStats()
    fed = FederationController(f"{root}/journal", stats=mstats)

    def drain_node(node) -> int:
        got = 0
        for w in node["daemon"].wires.all():
            while True:
                try:
                    w.egress.popleft()
                    got += 1
                except IndexError:
                    break
        return got

    def make_restarter(name):
        def restart():
            # graceful shutdown: the accept gate closes (a retrying
            # producer sees refusal, exactly like a stopped listener),
            # delivered egress goes to the consumer, the checkpoint
            # holds delay-line frames, QUEUED INGRESS, wires, counters;
            # then the full rebuild on the same port
            addr = nodes[name]["addr"]
            ck = f"{root}/ck{name}"

            def drain(node):
                delivered[0] += drain_node(node)

            r, _steps = restart_node(
                nodes[name], ck, dev, int(addr.rsplit(":", 1)[1]), drain,
                plane_kwargs=dict(dt_us=dt_us, seed=seed), node_ip=addr)
            r["engine"].node_ip = addr
            nodes[name] = dict(r, registry=r["tenancy"], addr=addr,
                               restarted=True,
                               pending_restored=r["pending"],
                               ingress_restored=r["ingress"])
            return PlaneHandle(name, r["daemon"], r["plane"],
                               r["tenancy"], checkpoint_dir=ck,
                               probe=grpc_probe(addr),
                               restarter=restart)

        return restart

    for name in ("A", "B"):
        node = nodes[name]
        fed.register(PlaneHandle(name, node["daemon"], node["plane"],
                                 node["registry"],
                                 checkpoint_dir=f"{root}/ck{name}",
                                 probe=grpc_probe(node["addr"]),
                                 restarter=make_restarter(name)))
    sup = FleetSupervisor(fed, f"{root}/ledger",
                          healthy_after=2).attach()

    fed_count = [0]
    delivered = [0]
    stop_feed = _threading.Event()

    # a RETRYING producer: each tenant wire is fed on whichever plane
    # currently realizes it; while a plane restarts (draining) its frames
    # wait — accepted frames are the loss denominator, exactly like a
    # client retrying a refused dial
    pace_s = 0.02
    chunk = max(1, int(offered_frames_per_s * pace_s / max(1, 2 * pairs)))
    keys = [(f"{ns}/{ns}-a{i}", base + i + 1)
            for ns, base in (("ta", 0), ("tb", pairs))
            for i in range(pairs)]
    feed = _threading.Thread(
        target=gated_producer, daemon=True,
        args=(nodes, ("A", "B"), keys, [b"U" * 64] * chunk, fed_count,
              stop_feed, pace_s))
    feed.start()
    report = None
    try:
        time.sleep(steady_s)
        report = sup.rolling_upgrade(planes=["A", "B"],
                                     verify_probes=2,
                                     verify_timeout_s=30.0)
        time.sleep(steady_s)
    finally:
        stop_feed.set()
        feed.join(timeout=5)
    # full drain: everything accepted must come out somewhere
    deadline = time.monotonic() + drain_timeout_s
    while time.monotonic() < deadline:
        for name in ("A", "B"):
            delivered[0] += drain_node(nodes[name])
        if delivered[0] >= fed_count[0]:
            break
        time.sleep(0.05)
    for name in ("A", "B"):
        nodes[name]["plane"].flush_peers(timeout_s=10.0)
        delivered[0] += drain_node(nodes[name])
    snap = mstats.snapshot()
    reports = (report or {}).get("reports", [])
    frames_lost = fed_count[0] - delivered[0]
    in_guardrails = (
        frames_lost == 0
        and len(reports) == 2
        and all(r["restarted"] and r["healthy"] and not r["error"]
                for r in reports)
        and all(nodes[n].get("restarted") for n in ("A", "B"))
        and snap["accounting_mismatch"] == 0.0
        and all(nodes[n]["plane"].tick_errors == 0
                for n in ("A", "B")))
    out = {
        "scenario": "fleet_rolling_upgrade",
        "device": str(dev),
        "pairs": pairs,
        "frames_fed": fed_count[0],
        "frames_delivered": delivered[0],
        "frames_lost": frames_lost,
        "migrations": (report or {}).get("migrations", 0),
        "reports": [{k: v for k, v in r.items()} for r in reports],
        "pending_restored": sum(
            int(nodes[n].get("pending_restored", 0))
            for n in ("A", "B")),
        "accounting_mismatch_gauge": snap["accounting_mismatch"],
        "migrations_completed": snap["completed"],
        "in_guardrails": in_guardrails,
        "wall_s": round(time.perf_counter() - t0, 3),
    }
    for name in ("A", "B"):
        try:
            nodes[name]["plane"].stop()
            nodes[name]["server"].stop(0)
        except Exception:
            pass
    shutil.rmtree(root, ignore_errors=True)
    return out


# The JAX module's ladder (kubedtn_tpu/scenarios.py LADDER), in its
# order: the ported scenarios, and the names still to be ported.
LADDER = {
    "3node": three_node,
    "fat_tree_64": fat_tree_64,
    "churn_1k": churn_1k,
    "routes_10k": routes_10k,
    "clos_100k": clos_100k,
    "reconcile_100k": reconcile_100k,
    "scale_1m": scale_1m,
    "chaos_flaps": chaos_flaps,
    "reconverge_10k": reconverge_10k,
    "burn_recovery": burn_recovery,
    "migration_under_flap": migration_under_flap,
    "plane_failover": plane_failover,
    "fleet_rolling_upgrade": fleet_rolling_upgrade,
}
NOT_PORTED = (
    "live_plane", "live_plane_soak", "chaos_soak", "whatif_sweep",
    "telemetry_overhead", "slo_overhead", "pause_observability",
    "sharded_soak", "staged_update_soak", "update_under_flap",
    "noisy_neighbor", "shm_producer_crash", "shm_soak", "tenant_soak",
)
