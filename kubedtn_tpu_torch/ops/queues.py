"""Packet-event data plane: multi-packet shaping + in-flight delay lines.

Port of kubedtn_tpu/ops/queues.py. Each simulation step advances every
edge by up to K packet slots through the netem+TBF chain, one slot after
the other, and packets whose departure lies beyond the step land in a
per-edge in-flight ring (the delay line) to be delivered by a later step.

Delivery is time-ordered, like netem's tfifo queue: each step releases
every in-flight slot whose departure time falls inside the step,
regardless of insertion order. The ring has `Q` slots per edge; inserting
into a full ring drops the packet (netem's finite qdisc limit). Every
packet carries a `final_dst` node so the routing layer can forward
delivered packets across several hops (kubedtn_tpu_torch.router).

On the card every slot of `shape_packets` is one launch of kernel K1
(ops/cuda/shaping.shape_step_flags); `shape_packets_plain` is the same
loop over the plain step (netem._shape_step_from_u) and is what the
kernel path is held against.
"""

from __future__ import annotations

import dataclasses

import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.edge_state import EdgeState

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class InFlight:
    """Per-edge delay line: packets shaped but not yet delivered.

    Times are step-relative µs (rolled each step with the EdgeState
    epoch). Empty slots have t == +inf."""

    t: torch.Tensor          # f32[E, Q] delivery time
    size: torch.Tensor       # f32[E, Q] bytes
    final_dst: torch.Tensor  # i32[E, Q] destination node for multi-hop
    corrupted: torch.Tensor  # bool[E, Q]

    @property
    def q(self) -> int:
        return self.t.shape[1]


COUNTER_NAMES = ("tx_packets", "tx_bytes", "rx_packets", "rx_bytes",
                 "dropped_loss", "dropped_queue", "dropped_ring",
                 "rx_corrupted", "duplicated", "reordered")


@dataclasses.dataclass(frozen=True)
class EdgeCounters:
    """Cumulative per-edge counters — the per-interface statistics schema
    of the reference's Prometheus collector (reference
    daemon/metrics/interface_statistics.go:19-65): tx/rx packets/bytes
    plus drop/error taxa. All f32[E]."""

    tx_packets: torch.Tensor    # entered the edge (post-source)
    tx_bytes: torch.Tensor
    rx_packets: torch.Tensor    # delivered out the far end
    rx_bytes: torch.Tensor
    dropped_loss: torch.Tensor  # netem loss
    dropped_queue: torch.Tensor  # TBF 50ms-queue overflow
    dropped_ring: torch.Tensor  # delay-line overflow (qdisc limit)
    rx_corrupted: torch.Tensor  # delivered but corrupt-flagged
    duplicated: torch.Tensor
    reordered: torch.Tensor


def init_inflight(capacity: int, q: int = 32, device=None) -> InFlight:
    """An empty delay line on `device` (None = the CUDA card)."""
    dev = resolve_device(device)
    return InFlight(
        t=torch.full((capacity, q), torch.inf, dtype=F32, device=dev),
        size=torch.zeros((capacity, q), dtype=F32, device=dev),
        final_dst=torch.full((capacity, q), -1, dtype=I32, device=dev),
        corrupted=torch.zeros((capacity, q), dtype=torch.bool, device=dev),
    )


def init_counters(capacity: int, device=None) -> EdgeCounters:
    dev = resolve_device(device)
    return EdgeCounters(**{name: torch.zeros(capacity, dtype=F32, device=dev)
                           for name in COUNTER_NAMES})


# -- K sequential shaping slots -------------------------------------------

def draw_shape_uniforms(state: EdgeState, k: int,
                        generator: torch.Generator) -> torch.Tensor:
    """[K, E, NU] uniforms of one step's K slots, from `generator` (on
    the state's device)."""
    return torch.rand((k, state.capacity, netem.NU), generator=generator,
                      dtype=F32, device=state.device)


def _slots(state: EdgeState, sizes, valid, t_arrival, generator, u):
    """(sizes, valid, t_arrival, u) slot-major: the [E, K] slot inputs as
    contiguous [K, E] rows, and the [K, E_u, NU] uniforms, given or drawn.
    Given uniforms may have E_u rows for E a multiple of E_u: row e then
    reads row e % E_u (a replica sweep's shared draws)."""
    E, K = sizes.shape
    if E != state.capacity:
        raise ValueError(f"{E} rows of slots for capacity {state.capacity}")
    if u is None:
        if generator is None:
            raise ValueError("shape_packets needs a generator or the draws "
                             "u")
        u = draw_shape_uniforms(state, K, generator)
    elif (u.dim() != 3 or u.shape[0] != K or u.shape[2] != netem.NU
          or u.shape[1] == 0 or E % u.shape[1]):
        raise ValueError(f"u must have shape ({K}, E_u, {netem.NU}) with "
                         f"E_u dividing {E}, got {tuple(u.shape)}")
    return (sizes.T.contiguous(), valid.T.contiguous(),
            t_arrival.T.contiguous(), u)


def shape_packets(state: EdgeState, sizes: torch.Tensor,
                  valid: torch.Tensor, t_arrival: torch.Tensor,
                  generator: torch.Generator | None = None, *,
                  u: torch.Tensor | None = None):
    """Shape up to K packets per edge, sequentially per edge.

    Args:
      sizes: f32[E, K]; valid: bool[E, K]; t_arrival: f32[E, K] —
        per-edge packet slots, arrival-ordered along K.
      generator: draws the [K, E, NU] uniforms when `u` is not given.
      u: f32[K, E_u, NU] uniforms, slot k's in u[k]; E_u = E, or a
        divisor of E whose rows repeat (row e reads row e % E_u).

    On CUDA tensors every slot is one launch of kernel K1; the first
    writes a fresh state and the others update that state in place, so
    the caller's `state` stays valid. CPU tensors go through K1's plain
    version. Returns (state', ShapeResult with [E, K] leaves)."""
    from kubedtn_tpu_torch.ops.cuda import shaping

    sz, ok, ta, u = _slots(state, sizes, valid, t_arrival, generator, u)
    departs, flags = [], []
    for k in range(sz.shape[0]):
        state, dep, fl = shaping.shape_step_flags(
            state, sz[k], ok[k], ta[k], u[k], donate=k > 0,
            u_rows=u.shape[1])
        departs.append(dep)
        flags.append(fl)
    return state, shaping.unpack_flags(torch.stack(departs, dim=1),
                                       torch.stack(flags, dim=1))


def shape_packets_plain(state: EdgeState, sizes: torch.Tensor,
                        valid: torch.Tensor, t_arrival: torch.Tensor,
                        generator: torch.Generator | None = None, *,
                        u: torch.Tensor | None = None):
    """shape_packets in plain tensor code on any device: the same K-slot
    loop over netem._shape_step_from_u, the plain version of K1. Same
    arguments, same draws, same results."""
    sz, ok, ta, u = _slots(state, sizes, valid, t_arrival, generator, u)
    reps = state.capacity // u.shape[1]
    slots = []
    for k in range(sz.shape[0]):
        uk = u[k] if reps == 1 else u[k].repeat(reps, 1)
        state, res = netem._shape_step_from_u(state, sz[k], ok[k], ta[k],
                                              uk)
        slots.append(res)
    return state, netem.ShapeResult(**{
        f.name: torch.stack([getattr(r, f.name) for r in slots], dim=1)
        for f in dataclasses.fields(netem.ShapeResult)})


# -- the delay line -------------------------------------------------------

def insert_inflight(fl: InFlight, depart: torch.Tensor, sizes: torch.Tensor,
                    final_dst: torch.Tensor, corrupted: torch.Tensor,
                    deliver: torch.Tensor):
    """Insert up to L shaped packets per edge into the delay line.

    deliver: bool[E, L] — which lanes hold a real packet to deliver (its
    departure is finite). The reference scans the lanes in order and puts
    each packet into the leftmost free slot; slots are only ever taken
    during the scan, so the r-th delivering lane of an edge lands in the
    edge's r-th free slot, and lanes beyond the free count are lost. That
    closed form is computed here in one pass over the ring, with no
    per-lane loop.

    Returns (fl', dropped_ring f32[E] count of packets lost to a full
    ring). `fl` is not modified."""
    E, L = depart.shape
    dev = depart.device
    free = fl.t == torch.inf                                    # [E, Q]
    free_rank = torch.cumsum(free, dim=1, dtype=I32) - 1
    lane_rank = torch.cumsum(deliver, dim=1, dtype=I32) - 1     # [E, L]
    n_free = free_rank[:, -1] + 1
    n_deliver = lane_rank[:, -1] + 1
    # lane_of[e, r] = the lane of edge e whose rank is r; column L takes
    # the lanes that deliver nothing
    lane_of = torch.zeros((E, L + 1), dtype=torch.int64, device=dev)
    lane_of.scatter_(
        1, torch.where(deliver, lane_rank, L).long(),
        torch.arange(L, dtype=torch.int64, device=dev).expand(E, L))
    take = free & (free_rank < n_deliver[:, None])
    src = lane_of.gather(1, torch.where(take, free_rank, 0).long())

    def put(new, old):
        return torch.where(take, new.gather(1, src), old)

    fl2 = InFlight(t=put(depart, fl.t), size=put(sizes, fl.size),
                   final_dst=put(final_dst, fl.final_dst),
                   corrupted=put(corrupted, fl.corrupted))
    dropped = torch.clamp_min(n_deliver - n_free, 0).to(F32)
    return fl2, dropped


def pop_due(fl: InFlight, dt_us):
    """Release every in-flight packet due within this step (t <= dt_us).

    Returns (fl', due mask bool[E, Q]) — the caller reads sizes and
    final_dst of `fl` under the mask (they are cleared only in fl'),
    then rolls the epoch. An empty slot stays empty: inf - dt is inf."""
    due = fl.t <= dt_us
    fl2 = InFlight(
        t=torch.where(due, torch.inf, fl.t - dt_us),
        size=torch.where(due, 0.0, fl.size),
        final_dst=torch.where(due, -1, fl.final_dst),
        corrupted=fl.corrupted & ~due,
    )
    return fl2, due
