"""Small fleets for the fleet supervisor's tests, built the same way from
either package's modules.

The shapes are tests/test_fleet.py's: a plane hosts its tenants'
`PAIRS` pod pairs (one 2 ms link each, uids base + i + 1) in capacity 64
at 2 ms ticks on an explicit clock, with wires on both ends; `fleet`
registers plane A (tenant t1, 10.0.0.1, optionally with a checkpoint
directory) and plane B (tenant bg, 10.0.0.2) with a federation
controller and attaches a FleetSupervisor over them.

Imports neither jax nor the JAX package at import time: the card tests
(tests/test_torch_cuda.py, run without tests/conftest.py) use it with
the port's modules.
"""

from __future__ import annotations

import importlib

from _torch_tenant_harness import mods, wire_def

PAIRS = 1
DT = 0.002
CAPACITY = 64


def fmods(pkg: str):
    """mods(pkg) plus the package's federation (its supervisor and
    placement modules), journal, chaos, checkpoint, scenarios, metrics,
    gRPC client and autopilot."""
    m = mods(pkg)
    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    get = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    m.fed = get("federation")
    m.sup = get("federation.supervisor")
    m.place = get("federation.placement")
    m.journal = get("federation.journal")
    m.chaos = get("chaos")
    m.ckpt = get("checkpoint")
    m.scen = get("scenarios")
    m.metrics = get("metrics.metrics")
    m.client = get("wire.client")
    m.autopilot = get("autopilot")
    return m


def build_plane(m, tenants: dict, addr: str, seed: int = 0,
                device="cpu", capacity: int = CAPACITY,
                latency: str = "2ms", telemetry: bool = False,
                depth: int = 1):
    """One plane over package `m` hosting `tenants` ({ns: base uid}) at
    pipeline depth `depth` (given: the packages' defaults differ on the
    CPU). Returns (daemon, plane, registry, store, engine)."""
    store = m.st.TopologyStore()
    kw = {"device": device} if m.pkg == "torch" else {}
    engine = m.eng.SimEngine(store, capacity=capacity, node_ip=addr, **kw)
    registry = m.ten.TenantRegistry(engine)
    props = m.ty.LinkProperties(latency=latency)
    for ns, base in tenants.items():
        registry.create(ns)
        for i in range(PAIRS):
            uid = base + i + 1
            a, b = f"{ns}-a{i}", f"{ns}-b{i}"
            for name, peer in ((a, b), (b, a)):
                store.create(m.ty.Topology(
                    name=name, namespace=ns, spec=m.ty.TopologySpec(links=[
                        m.ty.Link(local_intf="eth1", peer_intf="eth1",
                                  peer_pod=peer, uid=uid,
                                  properties=props)])))
                engine.setup_pod(name, ns)
    m.rec.Reconciler(store, engine).drain()
    daemon = m.srv.Daemon(engine)
    if m.pkg == "jax":
        from _torch_native_guard import ensure_jax_native

        ensure_jax_native()
    plane = m.rt.WireDataPlane(daemon, dt_us=DT * 1e6, seed=seed,
                               pipeline_depth=depth)
    if m.pkg == "jax":
        from _torch_native_guard import assert_jax_wheel

        assert_jax_wheel(plane)
    plane.pipeline_explicit_clock = True
    plane.attach_tenancy(registry)
    if telemetry:
        plane.enable_telemetry(window_s=10.0, sample_period=4)
    for ns, base in tenants.items():
        for i in range(PAIRS):
            for side in "ab":
                daemon._add_wire(wire_def(f"{ns}-{side}{i}", ns,
                                          base + i + 1))
    return daemon, plane, registry, store, engine


def fleet(m, tmp: str, chaos=None, ck_a=None, device="cpu",
          telemetry: bool = False, depth: int = 1, **sup_kw) -> dict:
    """Planes A (t1) and B (bg) at pipeline depth `depth` under one
    controller over `tmp`/journal and a FleetSupervisor over
    `tmp`/ledger, attached."""
    kw = dict(device=device, telemetry=telemetry, depth=depth)
    a = build_plane(m, {"t1": 0}, "10.0.0.1", **kw)
    b = build_plane(m, {"bg": PAIRS}, "10.0.0.2", **kw)
    stats = m.fed.MigrationStats()
    fed = m.fed.FederationController(f"{tmp}/journal", stats=stats,
                                     chaos=chaos)
    fed.register(m.fed.PlaneHandle("A", *a[:3], checkpoint_dir=ck_a))
    fed.register(m.fed.PlaneHandle("B", *b[:3]))
    sup = m.sup.FleetSupervisor(fed, f"{tmp}/ledger", chaos=chaos,
                                **sup_kw).attach()
    return {"A": a, "B": b, "fed": fed, "sup": sup, "stats": stats}


def feed_and_tick(daemon, plane, ns: str, base: int, ticks: int,
                  fpt: int = 3, k0: int = 0) -> int:
    """`ticks` explicit-clock ticks of `plane`, each after `fpt` frames
    on every a-side wire of tenant `ns`; returns the tick count k."""
    k = k0
    for _ in range(ticks):
        k += 1
        for i in range(PAIRS):
            w = daemon.wires.get_by_key(f"{ns}/{ns}-a{i}", base + i + 1)
            for _ in range(fpt):
                w.ingress.append(b"x" * 64)
        plane.tick(now_s=100.0 + k * DT)
    return k


def status_view(sup) -> dict:
    """The supervisor's status with every plane's last health as the
    JAX package reports it (the port's health adds `kdt_ext`)."""
    st = sup.status()
    for p in st["planes"]:
        if p["health"] is not None:
            p["health"] = {k: v for k, v in p["health"].items()
                           if k != "kdt_ext"}
    return st


def evacuation_view(sup) -> list:
    """The supervisor's evacuation records without their wall-clock
    stamp."""
    return [{k: v for k, v in r.items() if k != "at_s"}
            for r in sup.evacuations()]
