"""NetworkSim — the time-stepped data-plane runtime.

Port of kubedtn_tpu/sim.py. Traffic sources emit packets, the netem+TBF
chain shapes them (K sequential slots per edge, each one launch of
kernel K1 on the card), delay lines hold them in flight, deliveries
update per-edge counters — all over every edge at once. Virtual time
advances in fixed steps.

The JAX package scans a jitted step over per-step PRNG keys; here `run`
is a Python loop over `sim_step`, and the random inputs come from one
torch.Generator or are handed in (`StepDraws`).

Composes with the routing layer (kubedtn_tpu_torch.router) for multi-hop
forwarding.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from kubedtn_tpu_torch.models.traffic import (
    TrafficDraws,
    TrafficSpec,
    TrafficState,
    generate,
    init_traffic_state,
)
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.edge_state import EdgeState
from kubedtn_tpu_torch.ops.queues import (
    EdgeCounters,
    InFlight,
    init_counters,
    init_inflight,
    insert_inflight,
    pop_due,
    shape_packets,
)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class SimState:
    """Everything the data plane carries between steps."""

    edges: EdgeState
    inflight: InFlight
    counters: EdgeCounters
    traffic: TrafficState
    clock_us: torch.Tensor  # f32[] virtual clock (bounded-horizon sims)


@dataclasses.dataclass(frozen=True)
class StepDraws:
    """One step's random inputs: the traffic sources' draws and the
    [K, E, NU] uniforms of the K shaping slots (K = k_slots for
    `sim_step`, k_slots + k_fwd for the routed step)."""

    traffic: TrafficDraws
    shape_u: torch.Tensor


def init_sim(edges: EdgeState, q: int = 32) -> SimState:
    """A fresh simulator around `edges`, on the edges' device."""
    cap, dev = edges.capacity, edges.device
    return SimState(
        edges=edges,
        inflight=init_inflight(cap, q, dev),
        counters=init_counters(cap, dev),
        traffic=init_traffic_state(cap, dev),
        clock_us=torch.zeros((), dtype=F32, device=dev),
    )


def _add(c: EdgeCounters, **deltas) -> EdgeCounters:
    return dataclasses.replace(
        c, **{k: getattr(c, k) + v for k, v in deltas.items()})


def _count(mask: torch.Tensor) -> torch.Tensor:
    """f32[E] count of the set lanes of a bool[E, K] mask."""
    return mask.sum(dim=1).to(F32)


def as_dt(dt_us, device) -> torch.Tensor:
    """The step length as a 0-dim f32 tensor on `device`."""
    return torch.as_tensor(dt_us, dtype=F32, device=device)


def _step_parts(sim: SimState, spec: TrafficSpec, generator, k_slots: int,
                dt_us, size_scale=None, *, draws: StepDraws | None = None,
                shape_fn=shape_packets):
    """Shared body of `sim_step`: generate → shape → enqueue → deliver,
    split so a replica sweep can generate the (replica-independent)
    traffic once and run only `_finish_step` per replica.

    The traffic draws are taken from `generator` before the shaping
    uniforms. Returns (sim', due, res, sizes, t_arr)."""
    tstate, sizes, valid, t_arr = generate(
        spec, sim.traffic, dt_us, k_slots, generator,
        draws=None if draws is None else draws.traffic)
    return _finish_step(sim, tstate, sizes, valid, t_arr, generator, dt_us,
                        size_scale,
                        shape_u=None if draws is None else draws.shape_u,
                        shape_fn=shape_fn)


def replica_count(rows: int, traffic_rows: int) -> int:
    """N of a state laid out as N replicas of `traffic_rows` rows."""
    if traffic_rows <= 0 or rows % traffic_rows:
        raise ValueError(f"{rows} state rows are not a whole number of "
                         f"replicas of {traffic_rows} rows")
    return rows // traffic_rows


def replica_inputs(n: int, sizes, valid, t_arr, k_shape: int, generator,
                   shape_u):
    """One step's traffic ([E, K] each) for N replicas laid out
    replica-major (N x E rows), and the step's [k_shape, E, NU] shaping
    uniforms, drawn from `generator` unless given: every replica shares
    them (K1 reads row r's at r % E), so the draws, like the traffic,
    are the one-replica step's."""
    if shape_u is None:
        shape_u = torch.rand((k_shape, sizes.shape[0], netem.NU),
                             generator=generator, dtype=F32,
                             device=sizes.device)
    return (sizes.repeat(n, 1), valid.repeat(n, 1), t_arr.repeat(n, 1),
            shape_u)


def _finish_step(sim: SimState, tstate, sizes, valid, t_arr, generator,
                 dt_us, size_scale=None, *, shape_u=None,
                 shape_fn=shape_packets):
    """Steps 2-4 of the data-plane step (everything after traffic
    generation): shape → enqueue → deliver → counters → epoch roll.

    `sim` may hold N replicas of the E traffic rows, laid out
    replica-major: edges, delay line and counters with N x E rows, the
    traffic state and clock once (the twin's sweep, twin/engine.py). The
    step's traffic and uniforms are then generated once and shared, and
    `size_scale` (a scalar, or f32[N] per replica) multiplies the
    generated packet sizes — a replica's offered-load dial. With N = 1
    this is the one-state step."""
    n = replica_count(sim.edges.capacity, sizes.shape[0])
    if n > 1:
        sizes, valid, t_arr, shape_u = replica_inputs(
            n, sizes, valid, t_arr, sizes.shape[1], generator, shape_u)
    valid = valid & sim.edges.active[:, None]
    sizes = torch.where(valid, sizes, 0.0)  # keep byte counters honest
    if size_scale is not None:
        if torch.is_tensor(size_scale) and size_scale.dim() == 1:
            size_scale = size_scale.repeat_interleave(
                sizes.shape[0] // size_scale.shape[0])[:, None]
        sizes = sizes * size_scale

    # 2. qdisc chain (netem root + TBF child), K sequential slots per edge
    edges, res = shape_fn(sim.edges, sizes, valid, t_arr, generator,
                          u=shape_u)

    # 3. duplicates: the kernel re-enqueues a copy through the qdisc; the
    #    copy here shares its original's departure time (one extra lane
    #    per duplicated packet).
    dep_all = torch.cat([res.depart_us, res.depart_us], dim=1)
    sz_all = torch.cat([sizes, sizes], dim=1)
    corr_all = torch.cat([res.corrupted, res.corrupted], dim=1)
    deliver_all = torch.cat(
        [res.delivered, res.delivered & res.duplicated], dim=1)
    fdst = edges.dst[:, None].expand(dep_all.shape)

    fl, dropped_ring = insert_inflight(
        sim.inflight, dep_all, sz_all, fdst, corr_all, deliver_all)

    # 4. deliver everything due inside this step (reads pre-clear arrays)
    fl_after, due = pop_due(fl, dt_us)
    counters = _add(
        sim.counters,
        tx_packets=_count(valid),
        tx_bytes=sizes.sum(dim=1),
        rx_packets=_count(due),
        rx_bytes=torch.where(due, fl.size, 0.0).sum(dim=1),
        rx_corrupted=_count(due & fl.corrupted),
        dropped_loss=_count(res.dropped_loss),
        dropped_queue=_count(res.dropped_queue),
        dropped_ring=dropped_ring,
        duplicated=_count(res.duplicated),
        reordered=_count(res.reordered),
    )

    edges = netem.roll_epoch(edges, dt_us)
    sim2 = SimState(edges=edges, inflight=fl_after, counters=counters,
                    traffic=tstate, clock_us=sim.clock_us + dt_us)
    return sim2, due, res, sizes, t_arr


def sim_step(sim: SimState, spec: TrafficSpec, generator, k_slots: int,
             dt_us, *, draws: StepDraws | None = None,
             shape_fn=shape_packets):
    """One data-plane step: generate → shape → enqueue → deliver. The
    random inputs come from `generator` (a torch.Generator on the sim's
    device) unless `draws` gives them. `sim` is not modified.

    Returns (sim', delivered_mask bool[E, Q]) — the mask refers to the
    pre-pop in-flight arrays for callers needing per-packet delivery
    times."""
    sim2, due, _res, _sizes, _t_arr = _step_parts(
        sim, spec, generator, k_slots, dt_us, draws=draws,
        shape_fn=shape_fn)
    return sim2, due


def run(sim: SimState, spec: TrafficSpec, steps: int, dt_us: float,
        k_slots: int = 8, seed: int = 0, *,
        draws: Sequence[StepDraws] | None = None,
        shape_fn=shape_packets) -> SimState:
    """Advance `steps` × dt_us of virtual time. Draws come from a
    generator seeded with `seed` on the sim's device, or from `draws`
    (one StepDraws per step). `shape_fn` is queues.shape_packets (kernel
    K1 per slot on the card) or queues.shape_packets_plain."""
    dev = sim.edges.device
    if draws is not None and len(draws) != steps:
        raise ValueError(f"{len(draws)} draws for {steps} steps")
    generator = torch.Generator(device=dev).manual_seed(seed)
    dt = as_dt(dt_us, dev)
    for i in range(steps):
        sim, _ = sim_step(sim, spec, generator, k_slots, dt,
                          draws=None if draws is None else draws[i],
                          shape_fn=shape_fn)
    return sim


def conservation_residual(sim: SimState) -> torch.Tensor:
    """f32[E], per edge and exactly: packets offered plus duplicates,
    minus those delivered, dropped by netem loss, by the TBF queue or by
    a full delay line, or still in flight. Zero where the books close,
    which they do after any number of steps (routed ones too: a
    re-injected packet is offered anew on its next edge)."""
    c = sim.counters
    in_flight = torch.isfinite(sim.inflight.t).sum(dim=1)
    return (c.tx_packets + c.duplicated - c.rx_packets - c.dropped_loss
            - c.dropped_queue - c.dropped_ring - in_flight)


def throughput_bps(before: EdgeCounters, after: EdgeCounters,
                   elapsed_us: float):
    """Achieved per-edge goodput between two counter snapshots — the
    iperf-equivalent measurement for the bandwidth scenario (reference
    config/samples/tc/bandwidth.yaml)."""
    return (after.rx_bytes - before.rx_bytes) * 8.0 / (elapsed_us / 1e6)
