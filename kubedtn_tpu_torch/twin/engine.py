"""Batched replica engine: N perturbed futures × T virtual ticks.

Port of kubedtn_tpu/twin/engine.py. The replica axis is laid out
replica-major along the edge rows: the snapshot's E-row `SimState` (or
`RouterState`) is repeated into N x E rows, per-replica edit batches
scatter the perturbations in (update_links semantics), and a plain
Python loop over the T steps advances `sim._finish_step` /
`router._finish_router_step` on all N x E rows at once, with on-device
metric reductions — the delivery-latency histogram against the
telemetry bucket ladder, delivered/dropped counters, queue occupancy.
Only [N]-sized reductions cross to the host.

Every shaping slot of a step is ONE launch of kernel K1 over the N x E
rows (ops/cuda/shaping.shape_step_flags): the step's [E, NU] uniforms
are shared by the replicas, K1 reading row r's at r % E, exactly as the
JAX twin broadcasts its draws over the vmapped replica axis.

Determinism contract (pinned by tests/test_torch_twin.py):
- The per-step draws follow `sim.run`'s schedule — one generator seeded
  with `seed` on the snapshot's device, or the `draws` handed in (one
  `sim.StepDraws` per step, as `sim.run` takes them) — and are SHARED
  across replicas. Traffic is generated once per step (the sources do
  not depend on the replica), so replica 0 of an unperturbed sweep is
  bit-identical to the unbatched `sim.run`/`run_routed` on the same
  snapshot and draws, and padding replicas cannot perturb any real
  replica's streams — the same sweep at N=4 and N=64 returns identical
  per-scenario results.
- JAX's `lax.scan` and its AOT executable cache have no counterpart: the
  loop runs eagerly. `SweepResult.compile_s` reports the seconds that
  building and loading the shaping kernels took at their first use in
  this sweep, else 0.0.

Sharding: pass `mesh=` (parallel.mesh.make_replica_mesh) to split the
lanes over several cards — each card runs its block with no
communication, and the results are joined on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from kubedtn_tpu_torch import _build
from kubedtn_tpu_torch.convert import tree_to
from kubedtn_tpu_torch.models.traffic import TrafficSpec, generate
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops.edge_state import EdgeState
from kubedtn_tpu_torch.ops.queues import EdgeCounters, shape_packets
from kubedtn_tpu_torch.router import RouterState, _finish_router_step
from kubedtn_tpu_torch.sim import SimState, _finish_step, as_dt
# The latency reduction is the LINK TELEMETRY plane's: the same bucket
# ladder and histogram_quantile the live plane's per-edge window ring
# uses (kubedtn_tpu_torch/telemetry.py), so a sweep's p99 and the
# plane's p99 are the same statistic by construction.
from kubedtn_tpu_torch.telemetry import (N_BINS, _bucket_edges,
                                         percentiles_from_hist)
from kubedtn_tpu_torch.twin.snapshot import TwinSnapshot
from kubedtn_tpu_torch.twin.spec import ReplicaEdits, compile_scenarios

F32 = torch.float32

_COUNTER_KEYS = ("tx_packets", "tx_bytes", "rx_packets", "rx_bytes",
                 "dropped_loss", "dropped_queue", "dropped_ring",
                 "rx_corrupted", "duplicated", "reordered")


@dataclasses.dataclass
class SweepResult:
    """One sweep's outcome: per-scenario metrics + provenance."""

    names: list
    metrics: list           # dict per scenario (see _replica_metrics)
    replicas: int           # total replica lanes incl. baseline/padding
    ticks: int
    sim_seconds: float
    compile_s: float        # kernel build + load at first use, else 0.0
    run_s: float
    replicas_steps_per_s: float
    # the final replica-major state(s) (tests/forks): one batched state,
    # or a list of per-device blocks when the sweep ran on a mesh
    final: object = None


def _rep(x: torch.Tensor, n: int) -> torch.Tensor:
    """`x` repeated n times along its leading (row) axis (new tensor)."""
    return x.repeat(n, *([1] * (x.dim() - 1)))


def _broadcast_tree(tree, n: int):
    return type(tree)(**{f.name: _rep(getattr(tree, f.name), n)
                         for f in dataclasses.fields(tree)})


def _broadcast_sim(sim: SimState, n: int) -> SimState:
    """N replicas of `sim`, replica-major: edges, delay line and counters
    with N x E rows; the traffic state and clock shared (the sweep
    generates traffic once per step)."""
    return SimState(edges=_broadcast_tree(sim.edges, n),
                    inflight=_broadcast_tree(sim.inflight, n),
                    counters=_broadcast_tree(sim.counters, n),
                    traffic=sim.traffic, clock_us=sim.clock_us)


def _apply_edits(bedges: EdgeState, edits: ReplicaEdits,
                 rows_per_replica: int) -> EdgeState:
    """The perturbations of every replica, IN PLACE on the replica-major
    edges: one update_links scatter (row state reset, qdisc-reinstall
    semantics) over every replica's rows, then one active-mask clear.
    Invalid lanes are skipped — a no-edit replica's rows keep the base
    state's exact bits."""
    n = edits.n_replicas
    off = (np.arange(n, dtype=np.int64) * rows_per_replica)[:, None]
    valid = edits.valid.ravel()
    if valid.any():
        es.update_links(bedges, (edits.rows.astype(np.int64) + off).ravel(),
                        edits.props.reshape(-1, es.NPROP), valid)
    drows = (edits.drows.astype(np.int64) + off).ravel()[
        edits.dvalid.ravel()]
    if drows.size:
        bedges.active[torch.as_tensor(drows, device=bedges.device)] = False
    return bedges


def _lanes(edits: ReplicaEdits, lo: int, hi: int) -> ReplicaEdits:
    return ReplicaEdits(rows=edits.rows[lo:hi], props=edits.props[lo:hi],
                        valid=edits.valid[lo:hi], drows=edits.drows[lo:hi],
                        dvalid=edits.dvalid[lo:hi], scale=edits.scale[lo:hi])


def _blocks(mesh, n: int, device) -> list[tuple]:
    if mesh is None:
        return [(device, 0, n)]
    from kubedtn_tpu_torch.parallel.mesh import replica_sharding

    return replica_sharding(mesh, n)


def _pad_to(mesh, n_scenarios: int) -> int | None:
    if mesh is None:
        return None
    size = len(mesh)
    return -(-max(n_scenarios, 1) // size) * size


def _kernel_load_s(device: torch.device) -> float:
    """The shaping kernels' build + load time when this call is their
    first use on the card (SweepResult.compile_s)."""
    return _build.load_seconds("shaping") if device.type == "cuda" else 0.0


# -- the sweep loop -----------------------------------------------------

def _run_block(bsim: SimState, scale: torch.Tensor, spec: TrafficSpec,
               steps: int, dt_us: float, k_slots: int, seed: int, draws,
               shape_fn):
    """Advance one block of replicas `steps` steps. Returns the final
    state, the latency histograms f32[n, N_BINS], the mean queue
    occupancy f32[n] and the per-replica counter totals."""
    dev = bsim.edges.device
    n = int(scale.shape[0])
    generator = torch.Generator(device=dev).manual_seed(seed)
    dt = as_dt(dt_us, dev)
    edges_us = _bucket_edges(dev)
    hist = torch.zeros((n, N_BINS), dtype=F32, device=dev)
    occ = torch.zeros(n, dtype=F32, device=dev)
    ts = bsim.traffic
    for i in range(steps):
        d = None if draws is None else draws[i]
        ts, sizes, valid, t_arr = generate(
            spec, ts, dt, k_slots, generator,
            draws=None if d is None else d.traffic)
        bsim, _due, res, _sz, t_arr2 = _finish_step(
            bsim, ts, sizes, valid, t_arr, generator, dt, scale,
            shape_u=None if d is None else d.shape_u, shape_fn=shape_fn)
        # one-hop delivery latency of every shaped-and-delivered packet
        # this step (netem delay incl. rate backlog), binned against the
        # telemetry bucket ladder on device; a step's bin counts are
        # whole numbers below 2^24, so their f32 sums are exact
        lat = (res.depart_us - t_arr2).reshape(n, -1)
        idx = torch.searchsorted(edges_us, lat)
        hist = hist + torch.zeros_like(hist).scatter_add_(
            1, idx, res.delivered.reshape(n, -1).to(F32))
        occ = occ + torch.isfinite(bsim.inflight.t).reshape(n, -1).sum(
            dim=1).to(F32)
    totals = {k: getattr(bsim.counters, k).reshape(n, -1).sum(dim=1)
              for k in _COUNTER_KEYS}
    return bsim, hist, occ / steps, totals


def _run_routed_block(brs: RouterState, spec: TrafficSpec, flow_dst,
                      steps: int, dt_us: float, k_slots: int, k_fwd: int,
                      seed: int, draws, shape_fn):
    dev = brs.sim.edges.device
    n = int(brs.fwd_dropped.shape[0])
    generator = torch.Generator(device=dev).manual_seed(seed)
    dt = as_dt(dt_us, dev)
    ts = brs.sim.traffic
    for i in range(steps):
        d = None if draws is None else draws[i]
        ts, sizes_t, valid_t, t_arr_t = generate(
            spec, ts, dt, k_slots, generator,
            draws=None if d is None else d.traffic)
        brs = _finish_router_step(
            brs, flow_dst, ts, sizes_t, valid_t, t_arr_t, generator, k_fwd,
            dt, shape_u=None if d is None else d.shape_u,
            shape_fn=shape_fn)
    totals = {k: getattr(brs.sim.counters, k).reshape(n, -1).sum(dim=1)
              for k in _COUNTER_KEYS}
    totals["node_rx_packets"] = brs.node_rx_packets.reshape(n, -1).sum(1)
    totals["node_rx_bytes"] = brs.node_rx_bytes.reshape(n, -1).sum(1)
    totals["fwd_dropped"] = brs.fwd_dropped
    totals["no_route_dropped"] = brs.no_route_dropped
    return brs, totals


# -- percentiles from bucket counts: telemetry.percentiles_from_hist --

_percentiles = percentiles_from_hist


def _replica_metrics(i: int, totals_np: dict, start: dict,
                     hist: np.ndarray, occ: np.ndarray,
                     sim_seconds: float) -> dict:
    """One replica's report row. Two populations, deliberately:
    `latency_hist`/percentiles measure the SHAPING latency of every
    packet that left the qdisc chain (scheduled delivery, at shaping
    time — including packets whose pop falls past the horizon), while
    `delivered_packets`/`delivery_ratio` count pops WITHIN the horizon.
    A latency perturbation comparable to the sweep horizon therefore
    shows both a high p99 and a depressed delivery ratio — read
    together, they say "slow AND not yet arrived", not a contradiction."""
    delta = {k: float(totals_np[k][i]) - start.get(k, 0.0)
             for k in _COUNTER_KEYS}
    m = {
        "tx_packets": delta["tx_packets"],
        "delivered_packets": delta["rx_packets"],
        "delivered_bytes": delta["rx_bytes"],
        "dropped_loss": delta["dropped_loss"],
        "dropped_queue": delta["dropped_queue"],
        "dropped_ring": delta["dropped_ring"],
        "corrupted": delta["rx_corrupted"],
        "throughput_bps": (delta["rx_bytes"] * 8.0 / sim_seconds
                           if sim_seconds > 0 else 0.0),
        "delivery_ratio": (delta["rx_packets"] / delta["tx_packets"]
                           if delta["tx_packets"] > 0 else None),
        "mean_queue_occupancy": float(occ[i]),
        "latency_hist": [float(x) for x in hist[i]],
    }
    m.update(_percentiles(hist[i]))
    for extra in ("node_rx_packets", "node_rx_bytes", "fwd_dropped",
                  "no_route_dropped"):
        if extra in totals_np:
            m[extra] = float(totals_np[extra][i]) - start.get(extra, 0.0)
    return m


def _host_sum(x: torch.Tensor) -> float:
    return float(x.cpu().numpy().sum())


def _start_totals(counters: EdgeCounters) -> dict:
    return {k: _host_sum(getattr(counters, k)) for k in _COUNTER_KEYS}


def _joined(parts: list) -> np.ndarray:
    return np.concatenate([p.cpu().numpy() for p in parts])


# -- the entry points ---------------------------------------------------

def prepare_sweep(snapshot: TwinSnapshot, scenarios, *,
                  spec: TrafficSpec | None = None, mesh=None,
                  edits: ReplicaEdits | None = None, pod_ids=None):
    """Build the sweep's inputs without running anything: ``(blocks,
    spec, n_replicas)`` with one ``(bsim, scale)`` block per mesh entry
    (one block without a mesh): the replica-major state with every
    perturbation applied and the per-replica offered-load scale, on the
    block's device. `run_sweep` runs them."""
    names = [sc.name for sc in scenarios]
    if len(set(names)) != len(names):
        # reports and the wire surface key ranks by name — a duplicate
        # would silently collapse two lanes' results
        raise ValueError("scenario names must be unique")
    base = snapshot.sim
    if spec is None:
        from kubedtn_tpu_torch.twin.query import build_cbr_spec

        spec = build_cbr_spec(base.edges)
    if edits is None:
        edits = compile_scenarios(scenarios, base.edges, pod_ids=pod_ids,
                                  pad_replicas_to=_pad_to(mesh,
                                                          len(scenarios)))
    n = edits.n_replicas
    if n < len(scenarios):
        raise ValueError("edits cover fewer replicas than scenarios")
    E = base.edges.capacity
    blocks = []
    for dev, lo, hi in _blocks(mesh, n, base.edges.device):
        b = base if dev == base.edges.device else tree_to(base, dev)
        bsim = _broadcast_sim(b, hi - lo)
        _apply_edits(bsim.edges, _lanes(edits, lo, hi), E)
        scale = torch.as_tensor(edits.scale[lo:hi], dtype=F32, device=dev)
        blocks.append((bsim, scale))
    return blocks, spec, n


def run_sweep(snapshot: TwinSnapshot, scenarios, *, steps: int,
              dt_us: float, spec: TrafficSpec | None = None,
              k_slots: int = 4, seed: int = 0, mesh=None,
              edits: ReplicaEdits | None = None, pod_ids=None,
              keep_final: bool = False, draws=None,
              shape_fn=shape_packets) -> SweepResult:
    """Run one what-if sweep: scenario replicas forked from `snapshot`,
    advanced `steps` × `dt_us` of virtual time.

    Replica layout: lane i runs scenarios[i]; when `mesh` is given the
    lane count pads up to a multiple of the mesh size with unperturbed
    replicas (dropped from the results). `spec` defaults to the query
    surface's offered load (query.build_cbr_spec — the ONE default, so
    a library sweep and a WhatIf sweep answer the same question).
    `edits` short-circuits compilation for callers that prebuilt the
    batches. `draws` (one sim.StepDraws per step) replaces the seeded
    generator, as in sim.run; `shape_fn` is queues.shape_packets (kernel
    K1 per slot on the card) or queues.shape_packets_plain.
    """
    names = [sc.name for sc in scenarios]
    if steps <= 0:
        raise ValueError("a sweep needs at least one step")
    if draws is not None and len(draws) != steps:
        raise ValueError(f"{len(draws)} draws for {steps} steps")
    blocks, spec, n = prepare_sweep(snapshot, scenarios, spec=spec,
                                    mesh=mesh, edits=edits, pod_ids=pod_ids)
    compile_s = sum(_kernel_load_s(b.edges.device) for b, _s in blocks)
    t0 = time.perf_counter()
    outs = []
    for bsim, scale in blocks:
        dev = bsim.edges.device
        outs.append(_run_block(
            bsim, scale, spec if spec.mode.device == dev
            else tree_to(spec, dev), steps, dt_us, k_slots, seed,
            None if draws is None else [tree_to(d, dev) for d in draws],
            shape_fn))
    hist_np = _joined([o[1] for o in outs])
    occ_np = _joined([o[2] for o in outs])
    totals_np = {k: _joined([o[3][k] for o in outs]) for k in _COUNTER_KEYS}
    run_s = time.perf_counter() - t0

    sim_seconds = steps * dt_us / 1e6
    start = _start_totals(snapshot.sim.counters)
    metrics = [_replica_metrics(i, totals_np, start, hist_np, occ_np,
                                sim_seconds)
               for i in range(len(scenarios))]
    final = None
    if keep_final:
        final = outs[0][0] if len(outs) == 1 else [o[0] for o in outs]
    return SweepResult(
        names=names, metrics=metrics, replicas=n, ticks=steps,
        sim_seconds=sim_seconds, compile_s=round(compile_s, 3),
        run_s=round(run_s, 3),
        replicas_steps_per_s=round(n * steps / max(run_s, 1e-9), 1),
        final=final)


def _broadcast_router(rs: RouterState, n: int) -> RouterState:
    """N replicas of `rs`, replica-major (router._finish_router_step's
    batched layout): the routing table shared, pending lanes and node
    counters repeated, the drop counters f32[N]."""
    return RouterState(
        sim=_broadcast_sim(rs.sim, n), next_edge=rs.next_edge,
        pend_size=_rep(rs.pend_size, n), pend_dst=_rep(rs.pend_dst, n),
        pend_corr=_rep(rs.pend_corr, n),
        node_rx_packets=_rep(rs.node_rx_packets, n),
        node_rx_bytes=_rep(rs.node_rx_bytes, n),
        fwd_dropped=rs.fwd_dropped.reshape(1).repeat(n),
        no_route_dropped=rs.no_route_dropped.reshape(1).repeat(n))


def run_sweep_routed(snapshot: TwinSnapshot, scenarios, *, steps: int,
                     dt_us: float, spec: TrafficSpec, flow_dst,
                     k_slots: int = 4, k_fwd: int = 8, seed: int = 0,
                     mesh=None, pod_ids=None, keep_final: bool = False,
                     draws=None, shape_fn=shape_packets) -> SweepResult:
    """run_sweep over the multi-hop forwarding plane: the routed step on
    every replica's rows with the snapshot's routing table shared across
    replicas. Link perturbations apply per replica; offered-load scaling
    needs the unrouted engine (the routed step has no size dial), so a
    scaled scenario is rejected here. `draws` carry k_slots + k_fwd
    shaping slots per step, as run_routed takes them."""
    rs = snapshot.router
    if rs is None:
        raise ValueError("snapshot carries no RouterState; capture with "
                         "snapshot_from_router")
    for sc in scenarios:
        if sc.traffic_scale != 1.0:
            raise ValueError(
                f"scenario {sc.name!r}: traffic scale is only supported "
                f"by the unrouted sweep (run_sweep)")
    if draws is not None and len(draws) != steps:
        raise ValueError(f"{len(draws)} draws for {steps} steps")
    E = rs.sim.edges.capacity
    edits = compile_scenarios(scenarios, rs.sim.edges, pod_ids=pod_ids,
                              pad_replicas_to=_pad_to(mesh, len(scenarios)))
    n = edits.n_replicas
    blocks = []
    for dev, lo, hi in _blocks(mesh, n, rs.sim.edges.device):
        r = rs if dev == rs.sim.edges.device else tree_to(rs, dev)
        brs = _broadcast_router(r, hi - lo)
        _apply_edits(brs.sim.edges, _lanes(edits, lo, hi), E)
        blocks.append(brs)
    compile_s = sum(_kernel_load_s(b.sim.edges.device) for b in blocks)
    t0 = time.perf_counter()
    outs = []
    for brs in blocks:
        dev = brs.sim.edges.device
        outs.append(_run_routed_block(
            brs, tree_to(spec, dev),
            torch.as_tensor(flow_dst, dtype=torch.int32, device=dev),
            steps, dt_us, k_slots, k_fwd, seed,
            None if draws is None else [tree_to(d, dev) for d in draws],
            shape_fn))
    totals_np = {k: _joined([o[1][k] for o in outs]) for k in outs[0][1]}
    run_s = time.perf_counter() - t0

    sim_seconds = steps * dt_us / 1e6
    start = _start_totals(rs.sim.counters)
    start["node_rx_packets"] = _host_sum(rs.node_rx_packets)
    start["node_rx_bytes"] = _host_sum(rs.node_rx_bytes)
    start["fwd_dropped"] = _host_sum(rs.fwd_dropped)
    start["no_route_dropped"] = _host_sum(rs.no_route_dropped)
    zeros = np.zeros((n, N_BINS), np.float32)
    occ = np.zeros((n,), np.float32)
    metrics = [_replica_metrics(i, totals_np, start, zeros, occ,
                                sim_seconds)
               for i in range(len(scenarios))]
    for m in metrics:
        m.pop("latency_hist", None)
        for k in ("p50_us", "p90_us", "p99_us"):
            m[k] = None
    final = None
    if keep_final:
        final = outs[0][0] if len(outs) == 1 else [o[0] for o in outs]
    return SweepResult(
        names=[sc.name for sc in scenarios], metrics=metrics,
        replicas=n, ticks=steps, sim_seconds=sim_seconds,
        compile_s=round(compile_s, 3), run_s=round(run_s, 3),
        replicas_steps_per_s=round(n * steps / max(run_s, 1e-9), 1),
        final=final)


def replica_lane(state, i: int, n: int):
    """Lane i of a replica-major batched SimState or RouterState as the
    one-replica state it continues (views, no copy): rows [i*E, (i+1)*E)
    of every per-row tensor, the node counters' block i, the drop
    counters' entry i; the shared traffic state, clock and routing
    table as they are."""
    if isinstance(state, RouterState):
        sim = replica_lane(state.sim, i, n)
        e = sim.edges.capacity
        k = state.node_rx_packets.shape[0] // n
        return RouterState(
            sim=sim, next_edge=state.next_edge,
            pend_size=state.pend_size[i * e:(i + 1) * e],
            pend_dst=state.pend_dst[i * e:(i + 1) * e],
            pend_corr=state.pend_corr[i * e:(i + 1) * e],
            node_rx_packets=state.node_rx_packets[i * k:(i + 1) * k],
            node_rx_bytes=state.node_rx_bytes[i * k:(i + 1) * k],
            fwd_dropped=state.fwd_dropped[i],
            no_route_dropped=state.no_route_dropped[i])
    e = state.edges.capacity // n

    def lane(tree):
        return type(tree)(**{f.name: getattr(tree, f.name)[i * e:(i + 1) * e]
                             for f in dataclasses.fields(tree)})

    return SimState(edges=lane(state.edges), inflight=lane(state.inflight),
                    counters=lane(state.counters), traffic=state.traffic,
                    clock_us=state.clock_us)
