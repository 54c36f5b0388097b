"""Entry points of the port: the flagship shaping step and the 100k-link
Clos, the counterparts of __graft_entry__.entry() and bench.py's build(),
and the class groups of one live tick.

`entry()` returns the drop-in shaping step over a k=8 fat-tree edge
state (80 switches, 256 links -> 512 directed rows in capacity 1024)
plus example arguments. On the card the step runs kernel K1.
`dryrun_multichip(n)` runs one sharded simulation step of that state
over n virtual shards (parallel/sharded.py), as the JAX entry's
multi-device dryrun does.
`build_live_tick` packs the groups that runtime.fused_tick (and its
sharded form, whose ring steps run kernel K4) shapes in one tick.
`build_sim` and `build_routed` assemble the K-slot simulator and the
routed fabric over a loaded topology (each slot of a step is one launch
of kernel K1 on the card). Like the others they work on the device the
state lies on, and the loaders put the state on the card by default.

`build_daemon` builds the same 100k-link Clos the way a KubeDTN cluster
does — 600 Topology CRs through the store, the reconciler and the
SimEngine — behind a wire Daemon, and `build_plane` puts the live
WireDataPlane on top of it. `restore_daemon` brings a daemon and its
plane back from a checkpoint directory in the JAX CLI's restore order.
With `metrics_port`, either serves the daemon's Prometheus exporter
(metrics/metrics.py) as the JAX CLI's daemon does. `build_daemon(...,
tenancy=True)` attaches a tenancy.TenantRegistry before the reconcile
(every namespace becomes a tenant), `shm_dir` a shm.ShmIngest on that
directory; `build_plane` wires both into the plane, and
`restore_daemon` restores a checkpoint's registry. `build_daemon(...,
slo=True)` adds the SLO evaluator and the autopilot (disabled unless
`autopilot=True` or "dry-run") with their sidecars, on a plane with
telemetry. The daemon process (`tpudtn-torch daemon`, cli.cmd_daemon)
always attaches a registry, and with telemetry on the evaluator and the
autopilot; these builders leave each off unless asked, for the tests and
chip_smoke.py's phases that build planes in process. `build_federation` registers
several such daemons' planes with one federation controller, as the JAX
CLI's daemon registers its own, so MigrateTenant / MigrationStatus move
tenants between them (kubedtn_tpu_torch.federation). `build_fleet` puts
a fleet supervisor over such a controller, as the JAX CLI's daemon
attaches one before its autopilot: FleetStatus / FleetUpgrade answer,
Health answers for a named plane, and a dead plane is evacuated.
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


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One full sharded simulation step — batched link updates, per-edge
    shaping (kernel K1 per shard on the card), cross-shard per-node
    counters — over `n_devices` virtual shards of one device, the
    counterpart of __graft_entry__.dryrun_multichip: the fat-tree of
    `entry()` (80 switches, 512 directed rows in capacity 1024) and one
    64-row "20ms / 100Mbit" UpdateLinks batch. `device` None means the
    CUDA card. Checks that packets were delivered and that the
    cross-shard tx_packets total equals them, prints the JAX entry's OK
    line and returns {"n_devices", "device", "delivered",
    "tx_packets"}."""
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.parallel.mesh import make_mesh, shard_edge_state
    from kubedtn_tpu_torch.parallel.sharded import make_sharded_step

    dev = resolve_device(device)
    mesh = make_mesh([dev] * n_devices)
    _, state, sizes, have, t_arr = _build(dev)
    n_nodes = 80  # fat_tree(8) switch count
    shards = shard_edge_state(state, mesh)
    step = make_sharded_step(mesh, n_nodes=n_nodes)
    B = 64
    urows = np.arange(B, dtype=np.int32)
    uprops = np.stack(
        [es.props_row(LinkProperties(latency="20ms", rate="100Mbit")
                      .to_numeric())] * B)
    uvalid = np.ones(B, dtype=bool)
    generator = torch.Generator(device=mesh[0]).manual_seed(0)
    _, res, stats = step(shards, urows, uprops, uvalid, sizes, have, t_arr,
                         generator)
    delivered = sum(int(r.delivered.sum()) for r in res)
    if delivered <= 0:
        raise RuntimeError("sharded step delivered no packets")
    total_tx = float(stats.tx_packets.sum())
    if total_tx != delivered:
        raise RuntimeError(f"cross-shard tx_packets {total_tx} != "
                           f"{delivered} delivered")
    print(f"dryrun_multichip({n_devices}): OK — {delivered} packets shaped "
          f"across {n_devices} shards, psum'd node counters consistent")
    return {"n_devices": n_devices, "device": str(dev),
            "delivered": delivered, "tx_packets": total_tx}


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
             node_ip: str = "10.0.0.1", namespace: str = "default",
             uid_base: int = 0):
    """The Clos as Topology CRs, as the JAX package's reconcile_100k
    scenario writes them: one CR per spine and per leaf in `namespace`,
    link uids uid_base+1..uid_base+n_spine*n_leaf*links_per_pair, every
    pod placed on `node_ip` (the CNI ran) with no link realized yet
    (status.links = []). Fabrics in distinct namespaces with disjoint
    uid ranges share one store (one tenant each)."""
    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec

    props = props or LinkProperties(latency="10ms", rate="10Gbit")
    spines = [[] for _ in range(n_spine)]
    leaves = [[] for _ in range(n_leaf)]
    uid = uid_base
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
        t = Topology(name=name, namespace=namespace,
                     spec=TopologySpec(links=links))
        t.status.src_ip, t.status.net_ns = node_ip, f"/run/netns/{name}"
        t.status.links = []
        out.append(t)
    return out


def serve_metrics(daemon, plane, port: int = 0,
                  host: str = "0.0.0.0") -> dict:
    """The daemon's Prometheus exporter, wired as the JAX CLI's
    `cmd_daemon` wires it: a registry over the engine, the plane's
    counters, the plane, the WhatIf and update stats, the daemon's
    tenancy registry and shm ingest where attached; the request
    histogram observing every engine op (`engine.stats.observer`) and
    set on the daemon; a MetricsServer started on `port` (0 = pick one).
    The daemon's SLO evaluator and autopilot, where attached, get their
    collectors too, and so do its federation controller's
    MigrationStats (`build_federation`) and its fleet supervisor
    (`build_fleet`). Returns {"server", "registry",
    "hist", "port"}."""
    from kubedtn_tpu_torch.metrics.metrics import (MetricsServer,
                                                   make_registry)
    from kubedtn_tpu_torch.twin.query import stats_for
    from kubedtn_tpu_torch.updates.stager import stats_for as ustats_for

    engine = daemon.engine
    registry, hist = make_registry(engine,
                                   sim_counters_fn=plane.counters_fn,
                                   dataplane=plane,
                                   whatif_stats=stats_for(daemon),
                                   update_stats=ustats_for(daemon),
                                   tenancy=daemon.tenancy, shm=daemon.shm,
                                   slo=daemon.slo,
                                   autopilot=daemon.autopilot,
                                   migration_stats=(
                                       daemon.federation.stats
                                       if daemon.federation is not None
                                       else None),
                                   fleet=daemon.fleet)
    engine.stats.observer = hist
    daemon.hist = hist
    server = MetricsServer(registry, port=port, host=host)
    server.start()
    return {"server": server, "registry": registry, "hist": hist,
            "port": server.port}


def build_daemon(device=None, n_spine: int = N_SPINE, n_leaf: int = N_LEAF,
                 links_per_pair: int = LINKS_PER_PAIR,
                 capacity: int = 1 << 18, props=None,
                 node_ip: str = "10.0.0.1", metrics_port: int | None = None,
                 plane_kwargs: dict | None = None, tenancy=False,
                 shm_dir: str | None = None, crs=None, slo: bool = False,
                 autopilot=False) -> dict:
    """The Clos through the control plane on `device` (None = the CUDA
    card): `clos_crs` into a TopologyStore, one reconciler drain into a
    SimEngine of `capacity` rows, the engine flushed, a Daemon in front.
    Returns {"store", "engine", "reconciler", "daemon", "crs",
    "reconcile_s"} — reconcile_s is the drain plus the device flush,
    ended by a device sync. With `metrics_port`, the daemon's plane is
    built first (`build_plane(daemon, **plane_kwargs)`) and its exporter
    served on that port before the drain, so the request histogram sees
    every engine op; the dict then also holds "plane" and "metrics"
    (serve_metrics).

    With `tenancy`, a fresh tenancy.TenantRegistry is attached to the
    engine and the daemon before the drain, so the reconciler registers
    a tenant per namespace; a mapping {name: create() keyword arguments}
    creates those tenants first (quotas, QoS, a reserved block that the
    tenant's rows then pack into); with `shm_dir`, a shm.ShmIngest on that
    directory is set as the daemon's `shm` (cmd_daemon's --shm-dir).
    `crs` replaces the Clos's CRs (several tenant fabrics of
    `clos_crs(namespace=, uid_base=)`); the realized row count is then
    checked against their links. The dict then also holds "tenancy" and
    "shm".

    With `slo` (which needs `tenancy`), the SLO plane is wired as
    cmd_daemon wires it with telemetry on: the plane is built before the
    drain as for `metrics_port`, its telemetry enabled with cmd_daemon's
    defaults (1 s windows, every 256th frame sampled), an
    slo.SloEvaluator and an autopilot.Autopilot over it are attached to
    the daemon, and after the drain both sidecars start. The autopilot
    observes but stays disabled unless `autopilot` asks: True enables
    it, "dry-run" enables it in dry run (either implies `slo`). The dict
    then also holds "slo" and "autopilot"; the caller stops their
    sidecars (`stop()`)."""
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon

    import time

    want_slo = bool(slo or autopilot)
    if want_slo and not tenancy:
        raise ValueError("slo= and autopilot= need tenancy=: the "
                         "evaluator slices the telemetry ring by tenant")
    dev = resolve_device(device)
    store = TopologyStore()
    engine = SimEngine(store, capacity=capacity, node_ip=node_ip,
                       device=dev)
    if crs is None:
        crs = clos_crs(n_spine, n_leaf, links_per_pair, props, node_ip)
    for t in crs:
        store.create(t)
    engine.warm_kernels()
    daemon = Daemon(engine)
    out = {"tenancy": None, "shm": None, "slo": None, "autopilot": None}
    if tenancy:
        from kubedtn_tpu_torch.tenancy import TenantRegistry

        out["tenancy"] = daemon.tenancy = TenantRegistry(engine)
        if isinstance(tenancy, dict):
            for name, kw in tenancy.items():
                daemon.tenancy.create(name, **kw)
    if shm_dir is not None:
        import os

        from kubedtn_tpu_torch.shm import ShmIngest

        os.makedirs(shm_dir, exist_ok=True)
        out["shm"] = daemon.shm = ShmIngest(shm_dir)
    if metrics_port is not None or want_slo:
        out["plane"] = build_plane(daemon, **(plane_kwargs or {}))
    if want_slo:
        out["plane"].enable_telemetry(window_s=1.0, sample_period=256)
        _attach_slo(daemon, out, autopilot)
    if metrics_port is not None:
        out["metrics"] = serve_metrics(daemon, out["plane"], metrics_port)
    rec = Reconciler(store, engine)
    t0 = time.perf_counter()
    rec.drain()
    engine.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    reconcile_s = time.perf_counter() - t0
    n_links = sum(len(t.spec.links) for t in crs) // 2
    if engine.num_active != 2 * n_links:
        raise AssertionError(f"{engine.num_active} rows realized, "
                             f"expected {2 * n_links}")
    out.update(store=store, engine=engine, reconciler=rec, daemon=daemon,
               crs=crs, reconcile_s=reconcile_s)
    if out["slo"] is not None:
        out["slo"].start()
    if out["autopilot"] is not None:
        out["autopilot"].start()
    return out


def _attach_slo(daemon, out: dict, autopilot) -> None:
    """The SLO evaluator over the daemon's registry and plane and the
    autopilot over it, attached to the daemon and set in `out`: the
    autopilot enabled for `autopilot` True or "dry-run", in dry run for
    the latter."""
    from kubedtn_tpu_torch.autopilot import Autopilot
    from kubedtn_tpu_torch.slo import SloEvaluator

    plane = out["plane"]
    out["slo"] = SloEvaluator(daemon.tenancy, plane).attach(daemon)
    ap = Autopilot(daemon.tenancy, plane, out["slo"],
                   fleet=daemon.fleet).attach(daemon)
    if autopilot:
        ap.enable()
    if autopilot == "dry-run":
        ap.set_dry_run(True)
    out["autopilot"] = ap


def build_plane(daemon, **kwargs):
    """The live WireDataPlane over `daemon` (its engine's device);
    `kwargs` go to WireDataPlane (dt_us, max_slots, seed,
    pipeline_depth). The daemon's tenancy registry and shm ingest, where
    set, are attached to the plane (attach_tenancy; attach_shm with its
    watcher, as cmd_daemon does)."""
    from kubedtn_tpu_torch.runtime import WireDataPlane

    plane = WireDataPlane(daemon, **kwargs)
    if daemon.tenancy is not None:
        plane.attach_tenancy(daemon.tenancy)
    if daemon.shm is not None:
        plane.attach_shm(daemon.shm)
    return plane


def restore_daemon(ckpt_dir: str, device=None, store=None,
                   capacity: int = 1 << 18, node_ip: str = "10.0.0.1",
                   now_s: float | None = None,
                   metrics_port: int | None = None,
                   plane_kwargs: dict | None = None) -> dict:
    """A daemon and its live plane restored from the checkpoint
    directory `ckpt_dir` on `device` (None = the CUDA card), in the JAX
    CLI's order (kubedtn_tpu/cli.py cmd_daemon): `load_or_rebuild` (the
    reconstruction from `store` when the checkpoint is damaged and a
    store is given), the Daemon, the plane (`build_plane(daemon,
    **plane_kwargs)`), the checkpoint's tenancy registry where it has
    a tenancy section (`load_tenancy`, attached to the plane), then
    `load_wires`,
    `load_ingress`,
    `restore_plane_counters`, `load_pending` at `now_s` (None = the
    monotonic clock) and `consume_pending`. A damaged wire, ingress,
    counter or pending file is logged and skipped, as the CLI does; the
    pending file is consumed only once restored. A tenancy section
    that does not load raises CheckpointError: a restore never drops a
    registry's quotas, QoS classes or block reservations (after a
    rebuild from `store`, when the checkpoint was already found damaged,
    the failure is logged instead).

    With `now_s` on the saved plane's clock (an explicit-clock plane
    resumed where it was cut), the plane first resumes that clock
    (`WireDataPlane.resume_clock` with `plane_meta`'s origin_s and
    last_shaped_s): deadlines come from the same clock offsets, and the
    first tick rolls the restored token buckets and backlog clocks by
    the time since the last shaped tick, as the uninterrupted plane
    would. The JAX CLI's restore starts a new origin and leaves the
    epoch unset, so its first tick rolls by 0.

    Returns {"store", "engine", "daemon", "plane", "source", "tenancy",
    "wires", "ingress", "pending", "counters"} (+ "metrics" with
    `metrics_port`, served as `serve_metrics` does)."""
    from kubedtn_tpu_torch import checkpoint
    from kubedtn_tpu_torch.utils.logging import fields, get_logger
    from kubedtn_tpu_torch.wire.server import Daemon

    log = get_logger("checkpoint")
    try:
        # every loader below reads this one Generation: the manifest is
        # parsed once for the whole restore
        src = checkpoint.Generation(ckpt_dir)
    except checkpoint.CheckpointError:
        src = ckpt_dir  # load_or_rebuild reports it
    store, engine, source = checkpoint.load_or_rebuild(
        src, store=store, capacity=capacity, node_ip=node_ip,
        device=device)
    daemon = Daemon(engine)
    plane = build_plane(daemon, **(plane_kwargs or {}))
    try:
        registry = checkpoint.load_tenancy(src, engine)
    except checkpoint.CheckpointError:
        if source == "checkpoint":
            raise
        # the checkpoint was already found damaged and the engine
        # rebuilt from the store (logged by load_or_rebuild)
        log.exception("tenancy restore failed on a damaged checkpoint %s",
                      fields(path=ckpt_dir))
        registry = None
    if registry is not None:
        plane.attach_tenancy(registry)
    out = {"store": store, "engine": engine, "daemon": daemon,
           "plane": plane, "source": source, "tenancy": registry,
           "wires": 0, "ingress": 0, "pending": 0, "counters": False}
    try:
        out["wires"] = checkpoint.load_wires(src, daemon)
        out["ingress"] = checkpoint.load_ingress(src, daemon)
        out["counters"] = checkpoint.restore_plane_counters(src, plane)
    except checkpoint.CheckpointError:
        log.exception("wire/counter restore failed; continuing without %s",
                      fields(path=ckpt_dir))
    if now_s is not None and source == "checkpoint":
        meta = checkpoint.plane_meta(src)
        plane.resume_clock(now_s, meta.get("origin_s"),
                           meta.get("last_shaped_s"))
    try:
        out["pending"] = checkpoint.load_pending(src, plane,
                                                 now_s=now_s)
    except checkpoint.CheckpointError:
        # the file stays on disk: a later start can still restore it
        log.exception("pending-frame restore failed; continuing without "
                      "%s", fields(path=ckpt_dir))
    else:
        checkpoint.consume_pending(src)
    if metrics_port is not None:
        out["metrics"] = serve_metrics(daemon, plane, metrics_port)
    return out


def build_federation(members: dict, journal_root: str, chaos=None):
    """One federation.FederationController over `journal_root` with the
    planes of `members` registered, as the JAX CLI's daemon registers
    its own plane: {plane name: a federation.PlaneHandle, or a
    `build_daemon` dict}. A dict's daemon needs a tenancy registry
    (`build_daemon(..., tenancy=...)`); its "plane" is built with
    `build_plane(daemon)` where the dict has none, and set in it. The
    planes run where their daemons were built, the CUDA card by
    default (`build_daemon(device=None)`). Every daemon gets
    `federation` set to the controller (register() does it), so its
    MigrateTenant / MigrationStatus answer, ObserveSLO names the plane
    and `serve_metrics` exports the controller's MigrationStats.
    `chaos` (a chaos.ChaosInjector) arms migration-step faults.
    Returns the controller."""
    from kubedtn_tpu_torch.federation import (FederationController,
                                              PlaneHandle)

    fed = FederationController(journal_root, chaos=chaos)
    for name, m in members.items():
        if not isinstance(m, PlaneHandle):
            daemon = m["daemon"]
            if daemon.tenancy is None:
                raise ValueError(f"plane {name!r} has no tenancy "
                                 f"registry: migration moves tenants")
            if m.get("plane") is None:
                m["plane"] = build_plane(daemon)
            m = PlaneHandle(name, daemon, m["plane"], daemon.tenancy)
        fed.register(m)
    return fed


def build_fleet(fed, ledger_root: str, chaos=None, **machine):
    """A federation.FleetSupervisor over the controller `fed` with its
    placement ledger in `ledger_root`, attached as the JAX CLI's daemon
    attaches its own: every registered plane watched and its registry's
    tenants adopted into the ledger, the controller's `placement_hook`
    and every daemon's `fleet` set (FleetStatus, FleetUpgrade and
    ObserveSLO's fleet branch answer from it), journaled migrations a
    crash left running resumed. `machine` goes to the supervisor
    (suspect_after, dead_after, healthy_after, clock, stats); `chaos` (a
    chaos.ChaosInjector) arms probe faults. The caller sweeps, or starts
    the sweep loop (`start(interval_s=2.0)` is the JAX CLI's sidecar).

    The JAX CLI builds the supervisor before the autopilot, which takes
    it as `fleet` when it is built; `_attach_slo` does the same for a
    daemon built after it. An autopilot that was built earlier kept
    `fleet=None`: it is pointed at the supervisor here, so its
    escalation tier reaches `rebalance()`. Returns the supervisor."""
    from kubedtn_tpu_torch.federation import FleetSupervisor

    sup = FleetSupervisor(fed, ledger_root, chaos=chaos, **machine)
    sup.attach()
    for name in fed.plane_names():
        ap = fed.handle(name).daemon.autopilot
        if ap is not None:
            ap.fleet = sup
    return sup
