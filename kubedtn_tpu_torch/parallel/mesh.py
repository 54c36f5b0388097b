"""Device meshes of the sharded live tick.

A mesh is an ordered tuple of torch.devices along one axis, the edge
axis: shard s of the edge-state structure of arrays lives on mesh[s].
The same card may appear more than once: those are VIRTUAL SHARDS, each
its own block of the state on one card, running the very same sharded
program (its ring steps then copy within the card). They are the
counterpart of the JAX tests' 8-device CPU mesh under
--xla_force_host_platform_device_count, and what lets one H100 run the
sharded tick at all.
"""

from __future__ import annotations

import dataclasses

import torch

from kubedtn_tpu_torch.ops.edge_state import EdgeState
from kubedtn_tpu_torch.parallel.partition import shard_ranges

EDGE_AXIS = "edge"


def _normalise(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices) -> tuple:
    """A 1-D mesh over `devices` (a list of torch.devices or names, in
    shard order; repeats make virtual shards). A CUDA device without an
    index means the current card."""
    mesh = tuple(_normalise(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_edge_state(state: EdgeState, mesh) -> list[EdgeState]:
    """Split every EdgeState field into len(mesh) contiguous blocks along
    the edge axis, block s on mesh[s]: a list of per-shard EdgeStates of
    capacity / len(mesh) rows each (new tensors)."""
    ranges = shard_ranges(state.capacity, len(mesh))
    return [EdgeState(**{
        f.name: getattr(state, f.name)[lo:hi].to(dev, copy=True)
        for f in dataclasses.fields(EdgeState)})
        for (lo, hi), dev in zip(ranges, mesh)]
