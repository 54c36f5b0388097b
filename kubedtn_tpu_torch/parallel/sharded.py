"""Edge-sharded simulation step: link updates, shaping and per-node
counters over a mesh of shards.

Port of kubedtn_tpu/parallel/sharded.py, the scale path that replaces the
reference's "many daemons, peer-to-peer RPC" architecture (SURVEY.md
§5.8). The state is a list of per-shard EdgeStates (parallel/mesh.py
`shard_edge_state`): shard s holds rows [s*E/S, (s+1)*E/S) on mesh[s],
and virtual shards of one card run the very program that cards would.

- The batched link updates go to each shard as the rows of its own
  range, shifted to local rows; every other row of the batch is invalid
  there. Each shard runs `edge_state.update_links` on its block, so a
  row's update is bit for bit the unsharded one (with duplicate rows in
  one batch too: a shard sees them in batch order, as the whole state
  does).
- The per-edge shaping has no communication: each shard shapes its
  block through kernel K1 (ops/cuda/shaping.shape_step, the route of
  netem.shape_step_auto), one launch per shard and step, in place. The
  JAX step shapes through XLA here because a pallas_call has no
  partitioning rule (kubedtn_tpu/parallel/sharded.py:104-109); in the
  port K1 is that same function's kernel.
- The per-node counters need a cross-shard sum. Each shard sums its
  edges exactly, as 64-bit integers in units of 2^-16
  (router.node_sums_fixed); the partials are added in shard order and
  rounded to f32 once. Integer adds commute, so the sharded counters are
  the unsharded ones bit for bit at any size and on every run (the JAX
  package's f32 psum agrees while sums stay below 2^24).

Over a multi-process mesh (mesh.MultihostMesh) a process passes and gets
back only its own shards; the UpdateLinks batch and the [E] inputs stay
by global row, as every process builds the same topology. The int64
partials are all-gathered (mesh.gather_shards) and added in global shard
order, so NodeStats is the same on every rank and the one-process step's
on the same shards, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.parallel.mesh import (as_mesh, check_local,
                                             gather_shards, local_shards)
from kubedtn_tpu_torch.parallel.partition import shard_ranges
from kubedtn_tpu_torch.router import fixed_to_f32, node_sums_fixed

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class NodeStats:
    """Per-node traffic counters — the schema of the reference's
    per-interface Prometheus collector (interface_statistics.go:19-65),
    aggregated to nodes. All f32[n_nodes]."""

    tx_packets: torch.Tensor
    tx_bytes: torch.Tensor
    rx_packets: torch.Tensor  # delivered into the node
    rx_bytes: torch.Tensor
    dropped: torch.Tensor     # loss + queue drops on the node's egress


def cross_shard_sum(partials: list, device) -> torch.Tensor:
    """The int64 partials of the shards added in shard order on
    `device`."""
    total = partials[0].to(device)
    for p in partials[1:]:
        total = total + p.to(device)
    return total


def make_node_stats_fn(mesh, n_nodes: int):
    """The per-node counter reduction over `mesh`: stats(srcs, dsts,
    delivereds, sizes, droppeds) takes per-shard lists ([E/S] each, one
    block per shard this process holds, on its device) and returns
    NodeStats on the first such device. A mesh of one device gives the
    unsharded counters."""
    mesh = as_mesh(mesh)
    home = local_shards(mesh)[0][1]

    def stats(srcs, dsts, delivereds, sizes, droppeds) -> NodeStats:
        for name, xs in (("srcs", srcs), ("dsts", dsts),
                         ("delivereds", delivereds), ("sizes", sizes),
                         ("droppeds", droppeds)):
            check_local(mesh, len(xs), f"blocks of {name}")
        parts = []   # per shard: int64 [5, n_nodes] in NodeStats' order
        for src, dst, deliv, sz, drop in zip(srcs, dsts, delivereds, sizes,
                                             droppeds):
            deliv_p = deliv.to(F32)
            deliv_b = torch.where(deliv, sz, 0.0)
            parts.append(torch.stack([
                node_sums_fixed(values, node, n_nodes)
                for values, node in ((deliv_p, src), (deliv_b, src),
                                     (deliv_p, dst), (deliv_b, dst),
                                     (drop.to(F32), src))]))
        total = fixed_to_f32(cross_shard_sum(gather_shards(mesh, parts),
                                             home))
        return NodeStats(*total.unbind(0))

    return stats


def _batch_for_shard(urows, uvalid, lo: int, hi: int):
    """(rows, valid) of an UpdateLinks batch as shard [lo, hi) applies it:
    rows shifted by lo, every row outside the range invalid. Host arrays
    stay on the host, tensors where they are."""
    if isinstance(urows, torch.Tensor):
        rows = urows.long()
        valid = torch.as_tensor(uvalid, dtype=torch.bool, device=rows.device)
    else:
        rows = np.asarray(urows, np.int64)
        valid = np.asarray(uvalid, bool)
    return rows - lo, valid & (rows >= lo) & (rows < hi)


def _check_shards(shards, mesh) -> list:
    """The [lo, hi) row range of each of `shards`, which must be this
    process's shards of `mesh`, of one capacity, each on its device."""
    check_local(mesh, len(shards), "shards")
    E = shards[0].capacity * len(mesh)
    ranges = shard_ranges(E, len(mesh))
    for st, (s, dev) in zip(shards, local_shards(mesh)):
        lo, hi = ranges[s]
        if st.capacity != hi - lo:
            raise ValueError(f"shard {s} holds {st.capacity} rows, want "
                             f"{hi - lo}")
        if st.device != dev:
            raise ValueError(f"shard {s} lies on {st.device}, its mesh "
                             f"device is {dev}")
    return [ranges[s] for s, _ in local_shards(mesh)]


def make_sharded_step(mesh, n_nodes: int):
    """The sharded simulation step: link updates -> shaping -> stats.

    Returns step(shards, urows, uprops, uvalid, sizes, have, t_arr,
    generator=None, *, u=None) -> (shards', [ShapeResult per shard],
    NodeStats). `shards` is the list of this process's per-shard
    EdgeStates (every shard of a one-process mesh, block s on its
    device) and is DONATED: each block is updated in place, as
    netem.shape_step_auto donates its state. `urows` / `uprops` /
    `uvalid` are one UpdateLinks batch by global row; `sizes`, `have`
    and `t_arr` are the [E] inputs of shape_step by global row. The
    step's [E, NU] uniforms are drawn once, whole, from `generator` (on
    the process's first shard device) unless given as `u`, and shard s
    shapes with rows [lo, hi) of them: the same draws the unsharded step
    takes. Across processes every rank draws the whole array from the
    same seeded generator, and the draws agree only between like
    devices (CPU with CPU, card with card)."""
    from kubedtn_tpu_torch.ops.cuda import shaping

    mesh = as_mesh(mesh)
    stats_fn = make_node_stats_fn(mesh, n_nodes)
    home = local_shards(mesh)[0][1]

    def step(shards, urows, uprops, uvalid, sizes, have, t_arr,
             generator=None, *, u=None):
        ranges = _check_shards(shards, mesh)
        E = shards[0].capacity * len(mesh)
        if u is None:
            if generator is None:
                raise ValueError("the sharded step needs a generator or "
                                 "the draws u")
            u = torch.rand((E, netem.NU), generator=generator, dtype=F32,
                           device=home)
        elif tuple(u.shape) != (E, netem.NU):
            raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                             f"{(E, netem.NU)}")
        out, results, sizes_s = [], [], []
        for st, (lo, hi) in zip(shards, ranges):
            dev = st.device
            rows, valid = _batch_for_shard(urows, uvalid, lo, hi)
            st = es.update_links(st, rows, uprops, valid)
            sz = sizes[lo:hi].to(dev)
            st, res = shaping.shape_step(st, sz, have[lo:hi].to(dev),
                                         t_arr[lo:hi].to(dev),
                                         u[lo:hi].to(dev), donate=True)
            out.append(st)
            results.append(res)
            sizes_s.append(sz)
        stats = stats_fn([st.src for st in out], [st.dst for st in out],
                         [r.delivered for r in results], sizes_s,
                         [r.dropped_loss | r.dropped_queue
                          for r in results])
        return out, results, stats

    return step
