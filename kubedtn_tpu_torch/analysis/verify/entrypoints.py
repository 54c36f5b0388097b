"""The canonical probe plane of the dispatch probe.

The port's copy of kubedtn_tpu/analysis/verify/entrypoints.py's
`build_probe_plane`: three link pairs, one per shaping kernel class
(slot-independent, TBF, correlated-sequential), built through the
production control path (store → SimEngine → Reconciler → Daemon →
WireDataPlane) with telemetry ON. Shapes are pinned (capacity 16, one
busy row per class), so the per-tick counts the probe reports are
reproducible run to run.
"""

from __future__ import annotations

PROBE_CAPACITY = 16
PROBE_DT_US = 2_000.0


def _probe_props():
    from kubedtn_tpu_torch.api.types import LinkProperties

    return [
        LinkProperties(latency="3ms", jitter="1ms", loss="5"),    # ind
        LinkProperties(rate="2Gbit"),                             # tbf
        LinkProperties(latency="2ms", loss="10", loss_corr="25"),  # seq
    ]


def build_probe_plane(depth: int = 2, device=None):
    """The canonical three-class plane on `device` (None = the CUDA
    card), built through the production control path. Returns (plane,
    ingress_wires, egress_wires): traffic enters at pod a<i>'s wire and
    leaves at pod b<i>'s."""
    from kubedtn_tpu_torch.api.types import Link, Topology, TopologySpec
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.topology import (
        Reconciler,
        SimEngine,
        TopologyStore,
    )
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.server import Daemon

    store = TopologyStore()
    engine = SimEngine(store, capacity=PROBE_CAPACITY, device=device)
    props = _probe_props()
    for i, p in enumerate(props):
        a, b = f"a{i}", f"b{i}"
        store.create(Topology(name=a, spec=TopologySpec(links=[
            Link(local_intf="eth1", peer_intf="eth1", peer_pod=b,
                 uid=i + 1, properties=p)])))
        store.create(Topology(name=b, spec=TopologySpec(links=[
            Link(local_intf="eth1", peer_intf="eth1", peer_pod=a,
                 uid=i + 1, properties=p)])))
        engine.setup_pod(a)
        engine.setup_pod(b)
    Reconciler(store, engine).drain()
    daemon = Daemon(engine)
    win, wout = [], []
    for i in range(len(props)):
        win.append(daemon._add_wire(pb.WireDef(
            local_pod_name=f"a{i}", kube_ns="default", link_uid=i + 1,
            intf_name_in_pod="eth1")))
        wout.append(daemon._add_wire(pb.WireDef(
            local_pod_name=f"b{i}", kube_ns="default", link_uid=i + 1,
            intf_name_in_pod="eth1")))
    plane = WireDataPlane(daemon, dt_us=PROBE_DT_US, pipeline_depth=depth)
    plane.pipeline_explicit_clock = True
    plane.enable_telemetry(window_s=0.05, sample_period=4)
    return plane, win, wout
