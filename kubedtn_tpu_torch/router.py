"""RouterSim — multi-hop packet forwarding over the simulated fabric.

Port of kubedtn_tpu/router.py. Composes the data plane
(kubedtn_tpu_torch.sim) with the routing tables
(kubedtn_tpu_torch.ops.routing): packets carry a final destination node;
when a packet is delivered out of an edge whose far end is not its
destination, it re-enters the fabric on that node's next-hop edge in the
following step.

Forwarding is static-shape: every step, due packets are grouped by their
next-hop edge with a stable sort and a segmented rank, then scattered
into at most `k_fwd` re-injection lanes per edge (excess packets drop and
are counted, like a router's input-queue overflow).

Every result is the same bits on every run, on the card too: the
per-node delivery sums, the one place where many packets add into one
cell, accumulate in 64-bit fixed point (integer adds commute, float
atomics do not). Each step's per-node sum is exact and is added to the
running f32 total with one rounding; the reference adds packet by packet
into the running f32. The two are the same number while a node's byte
total stays below 2^24 (every partial sum is then a whole number that
f32 holds). Beyond it each f32 add rounds by up to half a spacing, here
once a step and there once a packet: the totals part by at most that
per packet delivered, and this one stays the nearer to the exact sum.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from kubedtn_tpu_torch.models.traffic import TrafficSpec, generate
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.queues import (InFlight, insert_inflight,
                                          pop_due, shape_packets)
from kubedtn_tpu_torch.sim import (SimState, StepDraws, _add, _count, as_dt,
                                   init_sim, replica_count, replica_inputs)

F32, I32, I64 = torch.float32, torch.int32, torch.int64

# per-node byte sums accumulate in units of 2^-16 byte
_FIXED_ONE = 65536.0


@dataclasses.dataclass(frozen=True)
class RouterState:
    """Forwarding-plane state carried between steps."""

    sim: SimState
    # i32[n, n] single-path routing table (edge rows), or i32[n, n, K]
    # ECMP next-hop groups from recompute_routes_ecmp (-1 padded): flows
    # hash across the group per (ingress edge, destination)
    next_edge: torch.Tensor
    pend_size: torch.Tensor        # f32[E, Kf] packets awaiting re-injection
    pend_dst: torch.Tensor         # i32[E, Kf] their final destinations
    pend_corr: torch.Tensor        # bool[E, Kf]
    node_rx_packets: torch.Tensor  # f32[n] packets that reached their dest
    node_rx_bytes: torch.Tensor    # f32[n]
    fwd_dropped: torch.Tensor      # f32[] packets lost to forwarding overflow
    no_route_dropped: torch.Tensor  # f32[] packets with no route to dest


def init_router(edges, next_edge: torch.Tensor, n_nodes: int, q: int = 32,
                k_fwd: int = 8) -> RouterState:
    """A fresh routed simulator around `edges`, on the edges' device."""
    sim = init_sim(edges, q=q)
    E, dev = edges.capacity, edges.device
    return RouterState(
        sim=sim,
        next_edge=next_edge.to(dev),
        pend_size=torch.zeros((E, k_fwd), dtype=F32, device=dev),
        pend_dst=torch.full((E, k_fwd), -1, dtype=I32, device=dev),
        pend_corr=torch.zeros((E, k_fwd), dtype=torch.bool, device=dev),
        node_rx_packets=torch.zeros(n_nodes, dtype=F32, device=dev),
        node_rx_bytes=torch.zeros(n_nodes, dtype=F32, device=dev),
        fwd_dropped=torch.zeros((), dtype=F32, device=dev),
        no_route_dropped=torch.zeros((), dtype=F32, device=dev),
    )


def _group_into_lanes(target: torch.Tensor, size: torch.Tensor,
                      fdst: torch.Tensor, corr: torch.Tensor,
                      live: torch.Tensor, E: int, k_fwd: int,
                      n_rep: int | None = None):
    """Scatter flat packets into per-edge lanes [E, k_fwd].

    target: int[M] destination edge row per packet (E = drop). Packets
    of one row keep their flat order (the sort is stable) and the first
    k_fwd of them get the lanes.
    Returns (size[E,Kf], dst[E,Kf], corr[E,Kf], valid[E,Kf], dropped
    count f32[]); with `n_rep` the rows are n_rep replicas of E / n_rep
    rows each and the dropped count is f32[n_rep], per replica."""
    M = target.shape[0]
    dev = target.device
    tgt = torch.where(live, target, E)
    tgt_s, order = torch.sort(tgt, stable=True)
    # segmented rank: position within each equal-target run, whose first
    # index a binary search of the sorted targets finds (the reference
    # takes a running maximum over the run starts: the same integers)
    rank = torch.arange(M, device=dev) - torch.searchsorted(tgt_s, tgt_s)

    in_row = tgt_s < E
    ok = in_row & (rank < k_fwd)
    # lanes without a slot land on the cut-off row E
    cell = torch.where(ok, tgt_s.long() * k_fwd + rank, E * k_fwd)

    def lanes(fill, dtype, vals):
        out = torch.full(((E + 1) * k_fwd,), fill, dtype=dtype, device=dev)
        out[cell] = vals
        return out[:E * k_fwd].view(E, k_fwd)

    out_sz = lanes(0.0, F32, size[order])
    out_dst = lanes(-1, I32, fdst[order])
    out_co = lanes(False, torch.bool, corr[order])
    out_ok = lanes(False, torch.bool, ok)
    over = in_row & (rank >= k_fwd)
    if n_rep is None:
        dropped = over.sum().to(F32)
    else:
        rep = torch.where(over, tgt_s // (E // n_rep), n_rep)
        dropped = torch.bincount(rep, minlength=n_rep + 1)[:n_rep].to(F32)
    return out_sz, out_dst, out_co, out_ok, dropped


def _node_sums(values: torch.Tensor, node: torch.Tensor,
               n_nodes: int, n_rep: int = 1) -> torch.Tensor:
    """f32[n] sum of `values` (f32[E], zero where nothing counts) over the
    edges of each node `node[e]`, the same bits on every run: the values
    are added as 64-bit integers in units of 2^-16 (exact for every
    multiple of that unit, so for whole bytes and counts), then rounded
    to f32 once. With `n_rep` replicas of E / n_rep rows the sums are
    f32[n_rep * n], replica-major."""
    return fixed_to_f32(node_sums_fixed(values, node, n_nodes, n_rep))


def fixed_to_f32(acc: torch.Tensor) -> torch.Tensor:
    """An int64 sum in units of 2^-16 rounded to f32 once."""
    return (acc.double() / _FIXED_ONE).to(F32)


def node_sums_fixed(values: torch.Tensor, node: torch.Tensor,
                    n_nodes: int, n_rep: int = 1) -> torch.Tensor:
    """`_node_sums` before its rounding: the exact int64 sums in units of
    2^-16. Sums of disjoint edge blocks add up to the sum of their union
    in any order (the sharded step's and router's cross-shard sums)."""
    total = n_rep * n_nodes
    acc = torch.zeros(total + 1, dtype=I64, device=values.device)
    # a node outside [0, n) lands on the cut-off row, as a scatter drops it
    ok = (node >= 0) & (node < n_nodes)
    if n_rep > 1:
        rows = values.shape[0] // n_rep
        node = node + torch.arange(values.shape[0], device=node.device,
                                   dtype=node.dtype) // rows * n_nodes
    row = torch.where(ok, node, total).long()
    acc.index_add_(0, row, (values.double() * _FIXED_ONE).to(I64))
    return acc[:total]


def _ecmp_pick(group: torch.Tensor, ingress: torch.Tensor,
               fd: torch.Tensor) -> torch.Tensor:
    """Hash (ingress edge, destination) onto each packet's next-hop
    group [M, K] — per-ingress path stickiness, the way hardware ECMP
    hashes header fields onto a group. The reference's uint32 arithmetic
    wraps; here it runs in int64 and is masked to 32 bits."""
    cnt = (group >= 0).sum(dim=-1)
    h = (ingress * 2654435761 + fd * 40503) & 0xFFFFFFFF
    k_idx = h % torch.clamp_min(cnt, 1)
    nxt = group.gather(1, k_idx[:, None])[:, 0]
    return torch.where(cnt > 0, nxt, -1)


def router_step(rs: RouterState, spec: TrafficSpec, flow_dst: torch.Tensor,
                generator, k_slots: int, k_fwd: int, dt_us, *,
                draws: StepDraws | None = None, shape_fn=shape_packets):
    """One routed data-plane step.

    `flow_dst` (i32[E]) gives the final-destination node of the host flow
    sourced on each edge; entries < 0 default to the edge's own far end
    (single-hop). Pending lanes are forwarded packets re-entering
    mid-path. The random inputs come from `generator` unless `draws`
    gives them (its shape_u then has k_slots + k_fwd slots). `shape_fn` is
    queues.shape_packets (kernel K1 per slot on the card) or
    queues.shape_packets_plain, as in sim.run. `rs` is not modified."""
    tstate, sizes_t, valid_t, t_arr_t = generate(
        spec, rs.sim.traffic, dt_us, k_slots, generator,
        draws=None if draws is None else draws.traffic)
    return _finish_router_step(
        rs, flow_dst, tstate, sizes_t, valid_t, t_arr_t, generator, k_fwd,
        dt_us, shape_u=None if draws is None else draws.shape_u,
        shape_fn=shape_fn)


@dataclasses.dataclass(frozen=True)
class Hop:
    """What one routed step leaves on a block of rows before forwarding:
    the next SimState, the pre-pop delay line `fl` and its `due` mask,
    the packets due at their destination, and for each flat (edge, slot)
    cell of the transit packets its final destination, liveness, and the
    flat index of its (here, destination) pair in the routing table."""

    sim: SimState
    fl: InFlight         # the delay line before the pop
    due: torch.Tensor    # bool[E, Q]
    at_dest: torch.Tensor
    flat_fd: torch.Tensor
    flat_live: torch.Tensor
    safe_fd: torch.Tensor
    pair: torch.Tensor
    n_nodes: int

    def rx_p_fixed(self, n_rep: int = 1) -> torch.Tensor:
        """Packets delivered to each node this step, exact int64 in
        units of 2^-16 (node_sums_fixed)."""
        return node_sums_fixed(_count(self.at_dest), self.sim.edges.dst,
                               self.n_nodes, n_rep)

    def rx_b_fixed(self, n_rep: int = 1) -> torch.Tensor:
        """Bytes delivered to each node this step, the same way."""
        return node_sums_fixed(
            torch.where(self.at_dest, self.fl.size, 0.0).sum(dim=1),
            self.sim.edges.dst, self.n_nodes, n_rep)


def hop(rs: RouterState, flow_dst: torch.Tensor, tstate, sizes_t, valid_t,
        t_arr_t, generator, dt_us, shape_u, shape_fn, n_nodes: int) -> Hop:
    """Steps 2-4 of a routed step on `rs`'s rows (the whole state, a
    replica sweep's N x E rows, or one shard's block): the sourced
    packets and the pending lanes shaped (shape_fn: K1 per slot on the
    card), into the delay lines, the due deliveries popped, the counters
    added and the epoch rolled; forwarding is the caller's."""
    sim = rs.sim
    valid_t = valid_t & sim.edges.active[:, None]
    sizes_t = torch.where(valid_t, sizes_t, 0.0)  # keep byte counters honest
    fd = torch.where(flow_dst >= 0, flow_dst, sim.edges.dst)
    fdst_t = fd[:, None].expand(sizes_t.shape)

    valid_p = rs.pend_dst >= 0
    sizes = torch.cat([sizes_t, rs.pend_size], dim=1)
    valid = torch.cat([valid_t, valid_p], dim=1)
    t_arr = torch.cat([t_arr_t, torch.zeros_like(rs.pend_size)], dim=1)
    fdst_in = torch.cat([fdst_t, rs.pend_dst], dim=1)

    # 2. shape through the qdisc chain
    edges, res = shape_fn(sim.edges, sizes, valid, t_arr, generator,
                          u=shape_u)

    # 3. into the delay lines (duplicates share the original's departure).
    #    A packet corrupted on ANY hop stays corrupted: carry the pending
    #    lanes' flag through this hop's result.
    corr_in = torch.cat(
        [torch.zeros_like(valid_t), rs.pend_corr & valid_p], dim=1)
    corr_now = res.corrupted | (corr_in & res.delivered)
    dep_all = torch.cat([res.depart_us, res.depart_us], dim=1)
    sz_all = torch.cat([sizes, sizes], dim=1)
    co_all = torch.cat([corr_now, corr_now], dim=1)
    fd_all = torch.cat([fdst_in, fdst_in], dim=1)
    deliver_all = torch.cat(
        [res.delivered, res.delivered & res.duplicated], dim=1)
    fl, dropped_ring = insert_inflight(
        sim.inflight, dep_all, sz_all, fd_all, co_all, deliver_all)

    # 4. deliveries due this step
    fl_after, due = pop_due(fl, dt_us)
    here = sim.edges.dst[:, None].expand(due.shape)
    at_dest = due & (fl.final_dst == here)
    in_transit = due & ~at_dest
    flat_fd = fl.final_dst.reshape(-1)
    flat_live = in_transit.reshape(-1)
    safe_here = torch.where(flat_live, here.reshape(-1), 0).long()
    safe_fd = torch.where(flat_live, torch.clamp_min(flat_fd, 0), 0).long()
    # a gather clamps an out-of-range node, as the reference's does
    pair = (safe_here.clamp_max(n_nodes - 1) * n_nodes
            + safe_fd.clamp_max(n_nodes - 1))

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
    return Hop(sim=sim2, fl=fl, due=due, at_dest=at_dest, flat_fd=flat_fd,
               flat_live=flat_live, safe_fd=safe_fd, pair=pair,
               n_nodes=n_nodes)


def _finish_router_step(rs: RouterState, flow_dst: torch.Tensor, tstate,
                        sizes_t, valid_t, t_arr_t, generator, k_fwd: int,
                        dt_us, *, shape_u=None, shape_fn=shape_packets):
    """Everything after traffic generation — split out so a replica
    sweep can generate the (replica-independent) traffic once.

    `rs` may hold N replicas of the E traffic rows, laid out
    replica-major as in sim._finish_step: edges, delay line, counters and
    pending lanes with N x E rows, node counters f32[N * n_nodes] and the
    forwarding drops f32[N]; the routing table, traffic state, flow
    destinations and the step's uniforms are shared. A replica's packets
    forward onto its own rows only. With 0-dim drop counters this is the
    one-state step."""
    sim = rs.sim
    E = sim.edges.capacity
    dev = sim.edges.device
    batched = rs.fwd_dropped.dim() == 1
    n = replica_count(E, sizes_t.shape[0])
    e_rep = E // n
    n_nodes = rs.node_rx_packets.shape[0] // n
    if n > 1:
        sizes_t, valid_t, t_arr_t, shape_u = replica_inputs(
            n, sizes_t, valid_t, t_arr_t, sizes_t.shape[1] + k_fwd,
            generator, shape_u)
        flow_dst = flow_dst.repeat(n)
    h = hop(rs, flow_dst, tstate, sizes_t, valid_t, t_arr_t, generator,
            dt_us, shape_u, shape_fn, n_nodes)
    fl, due = h.fl, h.due

    # 4a. final deliveries -> per-node counters: each edge's own total
    #     first (a fixed-order reduction), then edges into nodes
    node_rx_p = rs.node_rx_packets + fixed_to_f32(h.rx_p_fixed(n))
    node_rx_b = rs.node_rx_bytes + fixed_to_f32(h.rx_b_fixed(n))

    # 4b. transit packets -> next-hop edge, re-inject next step
    flat_fd, flat_live, safe_fd, pair = (h.flat_fd, h.flat_live, h.safe_fd,
                                         h.pair)
    if rs.next_edge.dim() == 3:
        group = rs.next_edge.reshape(n_nodes * n_nodes, -1).index_select(
            0, pair)
        # the hash reads the ingress edge's row within its replica
        ingress = (torch.arange(E, device=dev) % e_rep)[:, None].expand(
            due.shape).reshape(-1)
        nxt = _ecmp_pick(group, ingress, safe_fd)
    else:
        nxt = rs.next_edge.reshape(-1).index_select(0, pair)
    routed = flat_live & (nxt >= 0)
    no_route = flat_live & (nxt < 0)
    if n > 1:
        # the next hop's row in the packet's own replica
        nxt = nxt + (torch.arange(E, device=dev) // e_rep * e_rep)[
            :, None].expand(due.shape).reshape(-1).to(nxt.dtype)
    p_sz, p_dst, p_co, p_ok, fwd_drop = _group_into_lanes(
        torch.where(routed, nxt, E), fl.size.reshape(-1), flat_fd,
        fl.corrupted.reshape(-1), routed, E, k_fwd,
        n if batched else None)
    no_route_n = (no_route.view(n, -1).sum(dim=1) if batched
                  else no_route.sum()).to(F32)
    return RouterState(
        sim=h.sim,
        next_edge=rs.next_edge,
        pend_size=torch.where(p_ok, p_sz, 0.0),
        pend_dst=torch.where(p_ok, p_dst, -1),
        pend_corr=p_co & p_ok,
        node_rx_packets=node_rx_p,
        node_rx_bytes=node_rx_b,
        fwd_dropped=rs.fwd_dropped + fwd_drop,
        no_route_dropped=rs.no_route_dropped + no_route_n,
    )


def run_routed(rs: RouterState, spec: TrafficSpec, flow_dst, steps: int,
               dt_us: float, k_slots: int = 4, k_fwd: int = 8,
               seed: int = 0, *, draws: Sequence[StepDraws] | None = None,
               shape_fn=shape_packets) -> RouterState:
    """Advance `steps` routed steps. Draws come from a generator seeded
    with `seed` on the state's device, or from `draws` (one StepDraws per
    step). `shape_fn` is queues.shape_packets (kernel K1 per slot on the
    card) or queues.shape_packets_plain, the run that K1's is held
    against."""
    dev = rs.sim.edges.device
    if draws is not None and len(draws) != steps:
        raise ValueError(f"{len(draws)} draws for {steps} steps")
    generator = torch.Generator(device=dev).manual_seed(seed)
    dt = as_dt(dt_us, dev)
    flow_dst = torch.as_tensor(flow_dst, dtype=I32, device=dev)
    for i in range(steps):
        rs = router_step(rs, spec, flow_dst, generator, k_slots, k_fwd, dt,
                         draws=None if draws is None else draws[i],
                         shape_fn=shape_fn)
    return rs
