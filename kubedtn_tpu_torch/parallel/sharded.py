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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops import netem
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
    delivereds, sizes, droppeds) takes per-shard lists ([E/S] each, block
    s on mesh[s]) and returns NodeStats on mesh[0]'s device. A mesh of
    one device gives the unsharded counters."""
    mesh = tuple(mesh)

    def stats(srcs, dsts, delivereds, sizes, droppeds) -> NodeStats:
        for name, xs in (("srcs", srcs), ("dsts", dsts),
                         ("delivereds", delivereds), ("sizes", sizes),
                         ("droppeds", droppeds)):
            if len(xs) != len(mesh):
                raise ValueError(f"{len(xs)} blocks of {name} for a mesh of "
                                 f"{len(mesh)}")
        parts = {f.name: [] for f in dataclasses.fields(NodeStats)}
        for src, dst, deliv, sz, drop in zip(srcs, dsts, delivereds, sizes,
                                             droppeds):
            deliv_p = deliv.to(F32)
            deliv_b = torch.where(deliv, sz, 0.0)
            for name, values, node in (
                    ("tx_packets", deliv_p, src), ("tx_bytes", deliv_b, src),
                    ("rx_packets", deliv_p, dst), ("rx_bytes", deliv_b, dst),
                    ("dropped", drop.to(F32), src)):
                parts[name].append(node_sums_fixed(values, node, n_nodes))
        return NodeStats(**{
            name: fixed_to_f32(cross_shard_sum(p, mesh[0]))
            for name, p in parts.items()})

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
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
    E = sum(st.capacity for st in shards)
    ranges = shard_ranges(E, len(mesh))
    for s, (st, (lo, hi), dev) in enumerate(zip(shards, ranges, mesh)):
        if st.capacity != hi - lo:
            raise ValueError(f"shard {s} holds {st.capacity} rows, want "
                             f"{hi - lo}")
        if st.device != dev:
            raise ValueError(f"shard {s} lies on {st.device}, its mesh "
                             f"device is {dev}")
    return ranges


def make_sharded_step(mesh, n_nodes: int):
    """The sharded simulation step: link updates -> shaping -> stats.

    Returns step(shards, urows, uprops, uvalid, sizes, have, t_arr,
    generator=None, *, u=None) -> (shards', [ShapeResult per shard],
    NodeStats). `shards` is a list of per-shard EdgeStates (block s on
    mesh[s]) and is DONATED: each block is updated in place, as
    netem.shape_step_auto donates its state. `urows` / `uprops` /
    `uvalid` are one UpdateLinks batch by global row; `sizes`, `have`
    and `t_arr` are the [E] inputs of shape_step by global row. The
    step's [E, NU] uniforms are drawn once, unsharded, from `generator`
    (on mesh[0]'s device) unless given as `u`, and shard s shapes with
    rows [lo, hi) of them: the same draws the unsharded step takes."""
    from kubedtn_tpu_torch.ops.cuda import shaping

    mesh = tuple(mesh)
    stats_fn = make_node_stats_fn(mesh, n_nodes)

    def step(shards, urows, uprops, uvalid, sizes, have, t_arr,
             generator=None, *, u=None):
        ranges = _check_shards(shards, mesh)
        E = ranges[-1][1]
        if u is None:
            if generator is None:
                raise ValueError("the sharded step needs a generator or "
                                 "the draws u")
            u = torch.rand((E, netem.NU), generator=generator, dtype=F32,
                           device=mesh[0])
        elif tuple(u.shape) != (E, netem.NU):
            raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                             f"{(E, netem.NU)}")
        out, results, sizes_s = [], [], []
        for st, (lo, hi), dev in zip(shards, ranges, mesh):
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
