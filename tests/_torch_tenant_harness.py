"""Multi-tenant planes for the port's tenancy tests, built the same way
from either package's modules.

`mods("torch")` / `mods("jax")` name one package's engine, store,
reconciler, server, runtime, types and tenancy modules; `tenant_plane`
builds one plane over them hosting the given tenants' topologies (uids
and pod names global, so a solo plane of one tenant realizes the same
link identities as the cohabited plane); `run_schedule` feeds each
tenant's ingress wires on a deterministic explicit-clock schedule and
returns what each tenant's egress wires delivered, its telemetry totals
and its counter slice.

This module imports neither jax nor the JAX package at import time, so
the card tests (tests/test_torch_cuda.py, run without tests/conftest.py
where jax is absent) use it with the port's modules.
"""

from __future__ import annotations

import importlib
import types

import numpy as np

PAIRS = 2
DT_S = 0.002


def mods(pkg: str):
    """The modules of one package: "torch" (the port) or "jax"."""
    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    get = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    return types.SimpleNamespace(
        pkg=pkg, eng=get("topology.engine"), st=get("topology.store"),
        rec=get("topology.reconciler"), srv=get("wire.server"),
        rt=get("runtime"), ty=get("api.types"), ten=get("tenancy"))


def wire_def(pod: str, ns: str, uid: int):
    """A WireDef-shaped object (both Daemons take its attribute names)."""
    return types.SimpleNamespace(
        local_pod_name=pod, kube_ns=ns, link_uid=uid,
        intf_name_in_pod="eth1", veth_name_local_host="", peer_intf_id=0,
        peer_ip="")


def tenant_plane(m, tenant_names, props_map: dict, depth: int = 1,
                 seed: int = 0, pairs: int = PAIRS, device="cpu",
                 telemetry: bool = True, capacity: int | None = None,
                 shard=None, registry_kw=None):
    """One plane over package `m` hosting `tenant_names`' topologies:
    `pairs` pod pairs per tenant, each linked by one link of the
    tenant's props (`props_map[name]`, LinkProperties kwargs), uids
    index(name in sorted(props_map)) * pairs + i + 1. `shard(plane)`
    shards the plane after it is built; `registry_kw[name]` goes to the
    tenant's create(). Returns (plane, registry, {name: (wins, wouts)})."""
    all_names = sorted(props_map)
    store = m.st.TopologyStore()
    kw = {"device": device} if m.pkg == "torch" else {}
    engine = m.eng.SimEngine(
        store, capacity=capacity or 4 * pairs * len(all_names) + 8, **kw)
    registry = m.ten.TenantRegistry(engine)
    for ns in tenant_names:
        registry.create(ns, **(registry_kw or {}).get(ns, {}))
        lp = m.ty.LinkProperties(**props_map[ns])
        base = all_names.index(ns) * pairs
        for i in range(pairs):
            uid = base + i + 1
            a, b = f"{ns}-a{i}", f"{ns}-b{i}"
            for x, y in ((a, b), (b, a)):
                store.create(m.ty.Topology(
                    name=x, namespace=ns, spec=m.ty.TopologySpec(links=[
                        m.ty.Link(local_intf="eth1", peer_intf="eth1",
                                  peer_pod=y, uid=uid, properties=lp)])))
            engine.setup_pod(a, ns)
            engine.setup_pod(b, ns)
    m.rec.Reconciler(store, engine).drain()
    daemon = m.srv.Daemon(engine)
    if m.pkg == "jax":
        from _torch_native_guard import ensure_jax_native

        ensure_jax_native()
    plane = m.rt.WireDataPlane(daemon, dt_us=DT_S * 1e6,
                               pipeline_depth=depth, seed=seed)
    if m.pkg == "jax":
        from _torch_native_guard import assert_jax_wheel

        assert_jax_wheel(plane)
    plane.pipeline_explicit_clock = True
    plane.attach_tenancy(registry)
    if telemetry:
        plane.enable_telemetry(window_s=10.0, sample_period=4)
    if shard is not None:
        shard(plane)
    wires = {}
    for ns in tenant_names:
        base = all_names.index(ns) * pairs
        win, wout = [], []
        for i in range(pairs):
            uid = base + i + 1
            win.append(daemon._add_wire(wire_def(f"{ns}-a{i}", ns, uid)))
            wout.append(daemon._add_wire(wire_def(f"{ns}-b{i}", ns, uid)))
        wires[ns] = (win, wout)
    return plane, registry, wires


def tagged(ns: str, wire_i: int, j: int, size: int = 64) -> bytes:
    tag = f"{ns}/{wire_i}".encode()
    return tag + j.to_bytes(4, "big") + b"\x00" * (size - len(tag) - 4)


def run_schedule(m, tenant_names, props_map: dict, depth: int = 1,
                 ticks: int = 40, frames_per_tick=3, drain_ticks: int = 60,
                 **plane_kw):
    """Every tenant's every ingress wire gets `frames_per_tick` frames
    (an int, or a per-tenant dict) EVERY tick, so cohabited and solo
    planes dispatch on the same ticks (the same key chain), then idle
    ticks drain the tail. Returns ({name: per-wire egress lists},
    {name: telemetry totals over rows_of}, {name: tenant_counters},
    plane, registry)."""
    fpt = (frames_per_tick if isinstance(frames_per_tick, dict)
           else {ns: frames_per_tick for ns in tenant_names})
    plane, registry, wires = tenant_plane(m, tenant_names, props_map,
                                          depth=depth, **plane_kw)
    t = 100.0
    j = {ns: 0 for ns in tenant_names}
    for _ in range(ticks):
        for ns in tenant_names:
            for k, w in enumerate(wires[ns][0]):
                w.ingress.extend(tagged(ns, k, j[ns] + n)
                                 for n in range(fpt[ns]))
            j[ns] += fpt[ns]
        t += DT_S
        plane.tick(now_s=t)
    for _ in range(drain_ticks):
        t += DT_S
        plane.tick(now_s=t)
    plane.flush()
    plane.tick(now_s=t + 10.0)
    assert plane.tick_errors == 0
    delivered = {ns: [list(w.egress) for w in wires[ns][1]]
                 for ns in tenant_names}
    total, _secs = plane.telemetry.window_sum()
    tel = {}
    for ns in tenant_names:
        rows = registry.rows_of(ns)
        tel[ns] = total[rows[rows < total.shape[0]]].sum(axis=0)
    counters = {ns: registry.tenant_counters(plane, ns)
                for ns in tenant_names}
    return delivered, tel, counters, plane, registry
