"""Scenarios of the port, runnable functions returning a result dict.

Port of kubedtn_tpu/scenarios.py, in part: `_tenant_plane_setup` (the
multi-tenant plane harness) and `burn_recovery` (the SLO autopilot's
closed loop on one live plane). Both take a `device`, None meaning the
CUDA card. The rest of the JAX module (the BASELINE ladder, the soaks,
noisy_neighbor, whatif_sweep, ...) is ported with the CLI.
"""

from __future__ import annotations

import dataclasses
import time
import types

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.api.types import LinkProperties


def wire_def(pod: str, ns: str, uid: int):
    """A WireDef-shaped object (the Daemon takes its attribute names),
    so the harness needs no protobuf."""
    return types.SimpleNamespace(
        local_pod_name=pod, kube_ns=ns, link_uid=uid,
        intf_name_in_pod="eth1", veth_name_local_host="", peer_intf_id=0,
        peer_ip="")


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
