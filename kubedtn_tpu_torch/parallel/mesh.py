"""Device meshes of the sharded live tick.

A mesh is an ordered tuple of torch.devices along one axis, the edge
axis: shard s of the edge-state structure of arrays lives on mesh[s].
The same card may appear more than once: those are VIRTUAL SHARDS, each
its own block of the state on one card, running the very same sharded
program (its ring steps then copy within the card). They are the
counterpart of the JAX tests' 8-device CPU mesh under
--xla_force_host_platform_device_count, and what lets one H100 run the
sharded tick at all.

The what-if twin's replica axis has a mesh of its own
(`make_replica_mesh`): replicas of the whole edge state are
embarrassingly parallel, so `replica_sharding` splits the lanes into one
contiguous block per mesh entry, each block runs on its device with no
communication, and the sweep joins the blocks' results on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from kubedtn_tpu_torch.ops.edge_state import EdgeState
from kubedtn_tpu_torch.parallel.partition import shard_ranges

EDGE_AXIS = "edge"
# the what-if twin's scaling axis (kubedtn_tpu_torch.twin.engine)
REPLICA_AXIS = "replica"


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


def make_replica_mesh(n_devices: int | None = None,
                      devices=None) -> tuple:
    """A 1-D mesh over the what-if REPLICA axis: `devices` (default: every
    visible CUDA card), the first `n_devices` of them when given. With
    one card every lane stays on it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return make_mesh(devices)


def replica_sharding(mesh, n_replicas: int) -> list[tuple]:
    """(device, lo, hi) per mesh entry: lanes [lo, hi) of a sweep of
    `n_replicas` run on `device`. `n_replicas` must be a multiple of the
    mesh size (twin.spec pads with unperturbed replicas)."""
    size = len(mesh)
    if n_replicas % size:
        raise ValueError(f"{n_replicas} replicas do not split evenly over "
                         f"a mesh of {size}")
    per = n_replicas // size
    return [(dev, i * per, (i + 1) * per) for i, dev in enumerate(mesh)]
