"""Sharded multi-hop forwarding: the routed fabric over a mesh of shards,
with one all-to-all of transit packets per step.

Port of kubedtn_tpu/parallel/router.py. The reference completes
multi-node paths with daemon-to-daemon RPC — one unary gRPC per packet
(reference daemon/grpcwire/grpcwire.go:386-462). Here the forwarding
plane is split along the edge axis, and each step's packets whose next
hop lives on another shard cross in ONE all-to-all (SURVEY.md §5.7-5.8).

The sharded state is a list of per-shard RouterStates (`shard_router_state`):
shard s holds rows [s*E/S, (s+1)*E/S) of every per-edge leaf on mesh[s].
The routing table, the node counters, the two drop counters and the
clock are replicated, kept once per distinct device of the mesh: the
shards of one card share the same tensors.

Step anatomy, per shard:
  1. traffic, the pending re-injections, shaping (each slot one launch
     of kernel K1 on the card), the delay lines and the due deliveries,
     as router.router_step does on the whole state;
  2. the next hop of each transit packet from the replicated table;
  3. the packets bucketed by the shard that owns their next-hop row into
     a fixed [S, budget, 4] send buffer (overflow counted in
     `fwd_dropped`, like a router's input-queue drop);
  4. the all-to-all: shard d receives send[s][d] for s = 0..S-1, in
     shard order, and groups them into its pending lanes;
  5. the per-node delivery counters and the drop counts summed across
     shards: exact int64 partials added in shard order, rounded once.

Every sort is stable, so a receiving shard sees the packets in the
global flat order restricted to its rows: with no budget overflow and
the same draws, the sharded router is bit for bit the unsharded one
(`router.run_routed`), pending-lane order included.

The all-to-all is a collective, not a kernel (the JAX package's
`lax.all_to_all`). On one card it is a stack and a transpose of the S
send buffers; across cards one copy per (source card, destination card)
pair, the cards grouped as `exchange.ring_plan` groups them.

Random inputs: the JAX step folds the shard index into its key, so each
shard draws on its own. Here `draws` gives each shard's StepDraws (of
E/S rows), or each shard draws from its own torch.Generator
(`shard_generators`).

Over a multi-process mesh (mesh.MultihostMesh) a process holds and steps
only its own shards. The all-to-all crosses processes in one
all_to_all_single (mesh.all_to_all_shards), each receiving shard
reassembling its blocks in global shard order; the drop counts and the
node rx counters are all-gathered and summed in global shard order, so
they are the same on every rank; the replicated leaves are kept once per
distinct device of this process.
"""

from __future__ import annotations

import dataclasses

import torch

from kubedtn_tpu_torch.convert import shard, unshard
from kubedtn_tpu_torch.models.traffic import TrafficSpec, generate
from kubedtn_tpu_torch.ops.queues import shape_packets
from kubedtn_tpu_torch.parallel.mesh import (MultihostMesh,
                                             all_to_all_shards, as_mesh,
                                             check_local, gather_shards,
                                             local_shards, replicated)
from kubedtn_tpu_torch.parallel.partition import shard_ranges
from kubedtn_tpu_torch.parallel.sharded import cross_shard_sum
from kubedtn_tpu_torch.router import (RouterState, _group_into_lanes,
                                      fixed_to_f32, hop)
from kubedtn_tpu_torch.sim import SimState, StepDraws

F32, I32 = torch.float32, torch.int32

# the f32 packing of (local row, size, final_dst, corrupted) is exact for
# integers below this
EXACT_F32_INT = 1 << 24

# RouterState's leaves along the edge axis; the others are replicated
_SIM_EDGE_LEAVES = ("edges", "inflight", "counters", "traffic")
_EDGE_LEAVES = ("pend_size", "pend_dst", "pend_corr")
_REPLICATED = ("next_edge", "node_rx_packets", "node_rx_bytes",
               "fwd_dropped", "no_route_dropped")


def _per_device(x, mesh) -> dict:
    """{device: a copy of x on it}, one per distinct device of this
    process's shards of `mesh`."""
    return {dev: x.to(dev, copy=True) for dev in replicated(mesh)}


def shard_router_state(rs: RouterState, mesh) -> list[RouterState]:
    """Place a RouterState onto `mesh` as the sharded step takes it: a
    list of per-shard RouterStates, one for each shard this process
    holds, the per-edge leaves split into len(mesh) contiguous blocks
    (new tensors), the replicated leaves copied once per distinct device.
    The capacity must split evenly. The sharded router forwards
    single-path tables only."""
    if rs.next_edge.dim() != 2:
        raise AssertionError(
            "sharded router forwards single-path tables; build ECMP groups "
            "with recompute_routes_ecmp for the local router only")
    mesh = as_mesh(mesh)
    shard_ranges(rs.sim.edges.capacity, len(mesh))  # an even split
    sim_parts = {k: shard(getattr(rs.sim, k), mesh)
                 for k in _SIM_EDGE_LEAVES}
    edge_parts = {k: shard(getattr(rs, k), mesh) for k in _EDGE_LEAVES}
    rep = {k: _per_device(getattr(rs, k), mesh) for k in _REPLICATED}
    clock = _per_device(rs.sim.clock_us, mesh)
    return [RouterState(
        sim=SimState(**{k: v[i] for k, v in sim_parts.items()},
                     clock_us=clock[dev]),
        **{k: v[i] for k, v in edge_parts.items()},
        **{k: v[dev] for k, v in rep.items()})
        for i, (_, dev) in enumerate(local_shards(mesh))]


def gather_router_state(shards, device=None, mesh=None) -> RouterState:
    """The sharded state joined back into one RouterState on `device`
    (None = shard 0's device): per-edge leaves concatenated in shard
    order, replicated leaves from shard 0. With a multi-process `mesh`,
    `shards` are this process's and the call is a collective: every
    rank gets the whole state."""
    dev = shards[0].sim.edges.device if device is None else \
        torch.device(device)
    sims = [rs.sim for rs in shards]
    sim = SimState(**{k: unshard([getattr(x, k) for x in sims], dev, mesh)
                      for k in _SIM_EDGE_LEAVES},
                   clock_us=sims[0].clock_us.to(dev))
    return RouterState(
        sim=sim,
        **{k: unshard([getattr(rs, k) for rs in shards], dev, mesh)
           for k in _EDGE_LEAVES},
        **{k: getattr(shards[0], k).to(dev) for k in _REPLICATED})


def shard_generators(mesh, seed: int) -> list:
    """One torch.Generator for each shard this process holds: shard s's
    on its device, seeded with seed * 65536 + s (s its global index)."""
    return [torch.Generator(device=dev).manual_seed(seed * 65536 + s)
            for s, dev in local_shards(mesh)]


def shard_draws(draws: StepDraws, mesh) -> list:
    """One step's unsharded draws (traffic [E] / [E, K], shaping
    uniforms [K, E, NU]) as per-shard StepDraws of E/S rows, one for
    each shard this process holds, on its device: the sharded step then
    draws what the unsharded one does."""
    ranges = shard_ranges(draws.shape_u.shape[1], len(mesh))
    traffic = shard(draws.traffic, mesh)
    return [StepDraws(traffic=t, shape_u=draws.shape_u[
        :, ranges[s][0]:ranges[s][1]].to(dev).contiguous())
            for t, (s, dev) in zip(traffic, local_shards(mesh))]


def _bucket_by_shard(shard_of, lrow, size, fdst, corr, live,
                     n_shards: int, budget: int):
    """Scatter flat packets into [n_shards, budget, 4] send lanes.

    The stable sort and segmented rank of router._group_into_lanes,
    keyed by destination shard: the first `budget` packets bound for a
    shard, in flat order, get its lanes. Fields packed f32: (local_row,
    size, final_dst, corrupted); empty lanes hold -1. Returns (buf,
    dropped f32[] count of packets beyond the budget)."""
    M = shard_of.shape[0]
    dev = shard_of.device
    tgt = torch.where(live, shard_of, n_shards)
    tgt_s, order = torch.sort(tgt, stable=True)
    rank = torch.arange(M, device=dev) - torch.searchsorted(tgt_s, tgt_s)
    in_buf = tgt_s < n_shards
    ok = in_buf & (rank < budget)
    cell = torch.where(ok, tgt_s.long() * budget + rank,
                       n_shards * budget)
    fields = torch.stack([
        torch.where(live, lrow.to(F32), -1.0)[order],
        size[order],
        fdst.to(F32)[order],
        corr.to(F32)[order],
    ], dim=-1)                                   # [M, 4]
    buf = torch.full(((n_shards + 1) * budget, 4), -1.0, dtype=F32,
                     device=dev)
    buf[cell] = torch.where(ok[:, None], fields, -1.0)
    dropped = (in_buf & (rank >= budget)).sum().to(F32)
    return buf[:n_shards * budget].view(n_shards, budget, 4), dropped


def all_to_all(sends: list, mesh) -> list:
    """Shard d receives [S * budget, 4]: send[s][d] for s = 0..S-1, in
    shard order; `sends` and the result hold this process's shards. One
    copy per (source card, destination card) pair; on one card a stack
    and a transpose; across processes one all_to_all_single."""
    if isinstance(mesh, MultihostMesh):
        return [r.reshape(-1, 4) for r in all_to_all_shards(mesh, sends)]
    mesh = tuple(mesh)
    S = len(mesh)
    by_card: dict = {}
    for s, dev in enumerate(mesh):
        by_card.setdefault(dev, []).append(s)
    stacked = {dev: torch.stack([sends[s] for s in shards])
               for dev, shards in by_card.items()}   # [n_c, S, budget, 4]
    recv = [None] * S
    for ddev, dshards in by_card.items():
        full = torch.empty((S, len(dshards)) + tuple(sends[0].shape[1:]),
                           dtype=F32, device=ddev)
        for cdev, cshards in by_card.items():
            full[cshards] = stacked[cdev][:, dshards].to(ddev)
        for j, d in enumerate(dshards):
            recv[d] = full[:, j].reshape(-1, 4)
    return recv


def make_sharded_router_step(mesh, n_nodes: int, k_slots: int = 4,
                             k_fwd: int = 8, budget: int | None = None):
    """The sharded router step over `mesh`.

    Returns step(shards, spec, flow_dst, generators, dt_us, *, draws=None,
    shape_fn=shape_packets) -> shards'. `shards` is the list of
    `shard_router_state`, this process's shards (not modified); `spec`
    and `flow_dst` are the [E] traffic spec and flow destinations by
    global row (shard s reads its rows); `generators` one per shard
    (`shard_generators`), unless `draws` gives each shard's StepDraws of
    E/S rows (shape_u with k_slots + k_fwd slots). `budget` bounds each
    (source, destination) pair's transit packets a step (default
    max(8 k_fwd, 16), as JAX's); what exceeds it is counted in
    fwd_dropped. `shape_fn` is queues.shape_packets (K1 per slot on the
    card) or queues.shape_packets_plain."""
    mesh = as_mesh(mesh)
    S = len(mesh)
    local_ = local_shards(mesh)
    home = local_[0][1]
    if budget is None:
        budget = max(k_fwd * 8, 16)
    if n_nodes >= EXACT_F32_INT:
        raise ValueError(f"{n_nodes} nodes: the f32 packing of node ids is "
                         f"exact below {EXACT_F32_INT}")

    def local(rs: RouterState, spec, flow_dst, gen, dt_us, draws,
              shape_fn):
        """One shard's hop (router.hop) and its transit packets bucketed
        by the shard that owns their next-hop row: (Hop, send buffer,
        budget overflow count, no-route count)."""
        E_loc = rs.sim.edges.capacity
        tstate, sizes_t, valid_t, t_arr_t = generate(
            spec, rs.sim.traffic, dt_us, k_slots, gen,
            draws=None if draws is None else draws.traffic)
        h = hop(rs, flow_dst, tstate, sizes_t, valid_t, t_arr_t, gen, dt_us,
                None if draws is None else draws.shape_u, shape_fn, n_nodes)
        nxt = rs.next_edge.reshape(-1).index_select(0, h.pair)  # global row
        no_route = h.flat_live & (nxt < 0)
        live = h.flat_live & (nxt >= 0)
        shard_of = torch.where(live, torch.div(nxt, E_loc,
                                               rounding_mode="floor"), S)
        lrow = torch.where(live, nxt - shard_of * E_loc, -1)
        send, drop_tx = _bucket_by_shard(
            shard_of, lrow, h.fl.size.reshape(-1), h.flat_fd,
            h.fl.corrupted.reshape(-1), live, S, budget)
        return h, send, drop_tx, no_route.sum().to(F32)

    def step(shards, spec: TrafficSpec, flow_dst, generators, dt_us, *,
             draws=None, shape_fn=shape_packets):
        check_local(mesh, len(shards), "shards")
        E_loc = shards[0].sim.edges.capacity
        if E_loc >= EXACT_F32_INT:
            raise ValueError(f"{E_loc} rows a shard: the f32 packing of "
                             f"local rows is exact below {EXACT_F32_INT}")
        ranges = shard_ranges(E_loc * S, S)
        if draws is None and generators is None:
            raise ValueError("the sharded router needs generators or draws")
        locs = []
        for i, (rs, (s, dev)) in enumerate(zip(shards, local_)):
            if rs.sim.edges.device != dev or rs.sim.edges.capacity != E_loc:
                raise ValueError(f"shard {s} is {rs.sim.edges.capacity} "
                                 f"rows on {rs.sim.edges.device}, want "
                                 f"{E_loc} on {dev}")
            lo, hi = ranges[s]
            spec_s = TrafficSpec(**{
                f.name: getattr(spec, f.name)[lo:hi].to(dev)
                for f in dataclasses.fields(TrafficSpec)})
            locs.append(local(
                rs, spec_s, torch.as_tensor(flow_dst)[lo:hi].to(dev, I32),
                None if generators is None else generators[i],
                torch.as_tensor(dt_us, dtype=F32, device=dev),
                None if draws is None else draws[i], shape_fn))
        # THE collective: one all-to-all replaces the per-packet RPC
        recv = all_to_all([x[1] for x in locs], mesh)
        out, counts = [], []
        for (h, _, drop_tx, no_route), r in zip(locs, recv):
            r_row = r[:, 0].to(I32)
            r_live = r_row >= 0
            p_sz, p_dst, p_co, p_ok, drop_rx = _group_into_lanes(
                torch.where(r_live, r_row, E_loc), r[:, 1],
                r[:, 2].to(I32), r[:, 3] > 0.5, r_live, E_loc, k_fwd)
            out.append((h.sim, torch.where(p_ok, p_sz, 0.0),
                        torch.where(p_ok, p_dst, -1), p_co & p_ok))
            counts.append(torch.stack([drop_tx + drop_rx, no_route]))
        # the node rx counters: exact int64 partials added in shard order
        # and rounded once; the drops, whole counts exact in f32, summed
        # in shard order
        rx = fixed_to_f32(cross_shard_sum(gather_shards(mesh, [
            torch.stack([x[0].rx_p_fixed(), x[0].rx_b_fixed()])
            for x in locs]), home))
        fwd, nr = cross_shard_sum(gather_shards(mesh, counts), home)
        first = {}
        for rs, (_, dev) in zip(shards, local_):
            first.setdefault(dev, rs)
        rep, clock = {}, {}
        for dev, rs0 in first.items():
            clock[dev] = rs0.sim.clock_us + torch.as_tensor(
                dt_us, dtype=F32, device=dev)
            rep[dev] = dict(
                next_edge=rs0.next_edge,
                node_rx_packets=rs0.node_rx_packets + rx[0].to(dev),
                node_rx_bytes=rs0.node_rx_bytes + rx[1].to(dev),
                fwd_dropped=rs0.fwd_dropped + fwd.to(dev),
                no_route_dropped=rs0.no_route_dropped + nr.to(dev))
        return [RouterState(
            sim=dataclasses.replace(sim2, clock_us=clock[dev]),
            pend_size=ps, pend_dst=pd, pend_corr=pc, **rep[dev])
            for (sim2, ps, pd, pc), (_, dev) in zip(out, local_)]

    return step
