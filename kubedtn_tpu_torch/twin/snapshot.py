"""Snapshot-fork: consistent capture of a running twin.

Port of kubedtn_tpu/twin/snapshot.py. The consistency contract:

- From a LIVE data plane, the capture happens under the plane's tick
  lock AFTER a pipeline `flush()` — every in-flight shaping dispatch
  lands its edge-state write-back first, so the captured token buckets,
  correlation memory and backlog clocks are exactly the state the next
  live tick would shape against. The runner is paused for one barrier,
  never stopped: the real-time plane loses zero frames while a sweep
  runs.
- The engine's edge state is updated IN PLACE by the control plane and
  the plane's write-back (the JAX package holds immutable arrays, where
  a reference is the snapshot). So a capture from an engine or a plane
  CLONES the edge state inside the barrier: one device copy of every
  column, the price of the pause.
- From a pure `SimState`/`RouterState`, the snapshot is the state
  itself (a step never modifies its input): forking replicas from step
  t of a virtual run continues it bit-exactly (replica 0 of an
  unperturbed sweep equals the unforked run).

`save_snapshot` / `load_snapshot` persist a snapshot's SimState as one
npz through the checkpoint module's shared codec (the `<field>.<leaf>`
layout, edges inlined): the JAX package's snapshot files, read and
written by either package.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from kubedtn_tpu_torch.ops.edge_state import EdgeState
from kubedtn_tpu_torch.sim import SimState, init_sim


@dataclasses.dataclass(frozen=True)
class TwinSnapshot:
    """A consistent point-in-time fork base for the replica engine."""

    sim: SimState            # edges + inflight + counters + traffic + clock
    router: object | None    # RouterState when captured from a routed run
    n_nodes: int             # node-id space (blackhole resolution)
    captured_at_s: float     # wall clock of the capture
    source: str              # "plane" | "sim" | "router" | "engine"
    # live-plane virtual clock at capture (None unless source=="plane"),
    # kept as HOST float64 — sim.clock_us is f32 and a monotonic-clock
    # anchor (hours of µs) exceeds f32 spacing, so anchoring the device
    # clock would both mis-place it and freeze `clock_us + dt_us`
    plane_clock_s: float | None = None


def _clone_edges(state: EdgeState) -> EdgeState:
    return EdgeState(**{f.name: getattr(state, f.name).clone()
                        for f in dataclasses.fields(EdgeState)})


def snapshot_from_sim(sim: SimState, n_nodes: int = 0) -> TwinSnapshot:
    """Fork base from a virtual-time run's SimState (bit-exact resume)."""
    return TwinSnapshot(sim=sim, router=None, n_nodes=int(n_nodes),
                        captured_at_s=time.time(), source="sim")


def snapshot_from_router(rs, n_nodes: int | None = None) -> TwinSnapshot:
    """Fork base from a routed run's RouterState (bit-exact resume)."""
    if n_nodes is None:
        n_nodes = int(rs.node_rx_packets.shape[0])
    return TwinSnapshot(sim=rs.sim, router=rs, n_nodes=int(n_nodes),
                        captured_at_s=time.time(), source="router")


def snapshot_from_engine(engine, q: int = 32) -> TwinSnapshot:
    """Fork base from an engine with no data plane attached: a copy of
    the edge state (pending control-plane ops flushed first, by the
    `state` property) with a fresh delay line / traffic state."""
    with engine._lock:
        state = _clone_edges(engine.state)
        n_nodes = len(engine._pod_ids)
    return TwinSnapshot(sim=init_sim(state, q=q), router=None,
                        n_nodes=max(n_nodes, 1),
                        captured_at_s=time.time(), source="engine")


def snapshot_from_plane(plane, q: int = 32) -> TwinSnapshot:
    """Consistent capture from a LIVE WireDataPlane without stopping it.

    Takes the tick lock (the runner finishes its current tick and then
    waits one barrier), crosses `flush()` so every in-flight pipelined
    dispatch has written its dynamic edge-state columns back, copies the
    engine state, and releases — the runner's next tick proceeds
    normally. The live wheel-held frames are process state, not
    simulation state: replicas synthesize their own traffic from the
    captured shaping state.
    """
    engine = plane.engine
    with plane._tick_lock:
        plane.flush()
        with engine._lock:
            state = _clone_edges(engine.state)
            n_nodes = len(engine._pod_ids)
        clock_s = plane.last_now_s
    # fresh delay line + counters (the sweep measures the what-if
    # horizon); the virtual clock starts at 0 — the plane's own clock is
    # carried host-side in plane_clock_s (see the field note)
    sim = init_sim(state, q=q)
    return TwinSnapshot(sim=sim, router=None, n_nodes=max(n_nodes, 1),
                        captured_at_s=time.time(), source="plane",
                        plane_clock_s=clock_s)


# -- offline persistence (checkpoint-machinery npz codec) --------------

def save_snapshot(path: str, snap: TwinSnapshot) -> None:
    """Persist a snapshot's SimState as one npz via the checkpoint
    module's shared flatten (the `<field>.<leaf>` layout, edges inlined
    — one codec for both formats)."""
    from kubedtn_tpu_torch.checkpoint import flatten_sim_arrays

    flat = flatten_sim_arrays(snap.sim, include_edges=True)
    flat["n_nodes"] = np.asarray(snap.n_nodes, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_snapshot(path: str, device=None) -> TwinSnapshot:
    """A saved snapshot with its SimState on `device` (None = the
    card)."""
    from kubedtn_tpu_torch import resolve_device
    from kubedtn_tpu_torch.checkpoint import unflatten_sim_arrays

    dev = resolve_device(device)
    with np.load(path) as z:
        sim = unflatten_sim_arrays(z, device=dev)
        n_nodes = int(z["n_nodes"])
    return TwinSnapshot(sim=sim, router=None, n_nodes=n_nodes,
                        captured_at_s=time.time(), source="sim")
