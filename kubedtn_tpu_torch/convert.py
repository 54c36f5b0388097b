"""Carry state between the JAX package and this one through numpy.

The edge state is this system's "weights": with these functions the JAX
package and the port are fed one and the same state. A JAX state is
handed over as `{field: np.asarray(getattr(jax_state, field))}`, so this
module needs neither JAX nor the JAX package. A SimState or RouterState
goes over the same way with its nested dataclasses as nested dicts
(`sim_from_numpy`, `router_from_numpy`), and `tree_to_numpy` gives any of
the port's states back as such dicts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device, router, sim
from kubedtn_tpu_torch.models import traffic
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops import queues
from kubedtn_tpu_torch.ops.cuda.shaping import TiledShapeState

_DTYPES = {"uid": torch.int32, "src": torch.int32, "dst": torch.int32,
           "active": torch.bool, "pkt_count": torch.int32}


def edge_state_from_numpy(d: dict, device=None) -> es.EdgeState:
    """EdgeState on `device` (None = the CUDA card) from numpy arrays
    keyed by field name."""
    dev = resolve_device(device)
    return es.EdgeState(**{
        f.name: torch.as_tensor(
            np.array(d[f.name]),  # a writable copy (JAX hands read-only)
            dtype=_DTYPES.get(f.name, torch.float32), device=dev)
        for f in dataclasses.fields(es.EdgeState)})


def edge_state_to_numpy(s: es.EdgeState) -> dict:
    """{field: numpy array} of an EdgeState (copied to the host)."""
    return {f.name: np.array(getattr(s, f.name).cpu())
            for f in dataclasses.fields(es.EdgeState)}


def _leaf_dtype(x: np.ndarray) -> torch.dtype:
    """The port's dtype of a state leaf: bool stays, integers are int32,
    floats float32 (the JAX package's own, with x64 off)."""
    if x.dtype == np.bool_:
        return torch.bool
    return torch.int32 if np.issubdtype(x.dtype, np.integer) \
        else torch.float32


def _tree_from_numpy(cls, d: dict, dev):
    """A (nested) dataclass of tensors from {field: numpy array or the
    nested dataclass's dict}."""
    out = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, dict):
            out[f.name] = _tree_from_numpy(_NESTED[f.name], v, dev)
        else:
            x = np.array(v)  # a writable copy (JAX hands read-only)
            out[f.name] = torch.as_tensor(x, dtype=_leaf_dtype(x),
                                          device=dev)
    return cls(**out)


def tree_to_numpy(s) -> dict:
    """{field: numpy array} of a (nested) dataclass of arrays, nested
    dataclasses as nested dicts (copied to the host). The leaves are the
    port's tensors or anything numpy reads, so a JAX state goes through
    too: the result is what sim_from_numpy / router_from_numpy take."""
    return {f.name: (tree_to_numpy(v) if dataclasses.is_dataclass(v)
                     else np.array(v.cpu() if isinstance(v, torch.Tensor)
                                   else v))
            for f in dataclasses.fields(s)
            for v in (getattr(s, f.name),)}


def tree_to(s, device):
    """A copy of a (nested) dataclass of tensors on `device`."""
    if dataclasses.is_dataclass(s):
        return type(s)(**{f.name: tree_to(getattr(s, f.name), device)
                          for f in dataclasses.fields(s)})
    return s.to(device)


# the nested dataclass behind each field name of SimState / RouterState
_NESTED = {"edges": es.EdgeState, "inflight": queues.InFlight,
           "counters": queues.EdgeCounters, "traffic": traffic.TrafficState,
           "sim": sim.SimState}


def sim_from_numpy(d: dict, device=None) -> sim.SimState:
    """SimState on `device` (None = the CUDA card) from the leaves of a
    JAX SimState as numpy arrays: {"edges": {...}, "inflight": {...},
    "counters": {...}, "traffic": {...}, "clock_us": array}."""
    return _tree_from_numpy(sim.SimState, d, resolve_device(device))


def router_from_numpy(d: dict, device=None) -> router.RouterState:
    """RouterState on `device` (None = the CUDA card) from the leaves of
    a JAX RouterState as numpy arrays, its "sim" as sim_from_numpy
    takes it."""
    return _tree_from_numpy(router.RouterState, d, resolve_device(device))


def dyn_from_numpy(dyn, device=None) -> tuple:
    """The live tick's five dynamic columns (tokens, t_last,
    backlog_until, corr, pkt_count) on `device` (None = the CUDA card)
    from numpy arrays, as a JAX tick returns them."""
    dev = resolve_device(device)
    dtypes = (torch.float32,) * 4 + (torch.int32,)
    return tuple(torch.as_tensor(np.array(x), dtype=t, device=dev)
                 for x, t in zip(dyn, dtypes))


def tel_from_numpy(tel, device=None) -> torch.Tensor:
    """A [E, KCOLS] telemetry window on `device` (None = the CUDA card)."""
    return torch.as_tensor(np.array(tel), dtype=torch.float32,
                           device=resolve_device(device))


def shard(x, mesh) -> list:
    """Split along the edge axis into len(mesh) contiguous blocks, block
    s on shard s's device, one for each shard this process holds (every
    shard of a one-process mesh): a tensor gives a list of tensors, a
    tuple of tensors (the dynamic columns) a list of per-shard tuples, an
    EdgeState a list of per-shard EdgeStates, any other dataclass of
    [E, ...] tensors (an InFlight, a TrafficSpec) a list of its blocks."""
    from kubedtn_tpu_torch.parallel.mesh import (local_shards,
                                                 shard_edge_state)

    if isinstance(x, es.EdgeState):
        return shard_edge_state(x, mesh)
    local = local_shards(mesh)
    if dataclasses.is_dataclass(x):
        parts = {f.name: shard(getattr(x, f.name), mesh)
                 for f in dataclasses.fields(x)}
        return [type(x)(**{k: v[i] for k, v in parts.items()})
                for i in range(len(local))]
    if isinstance(x, torch.Tensor):
        n = len(mesh)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows not divisible by {n} "
                             "shards")
        blocks = x.split(x.shape[0] // n)
        return [blocks[s].to(d, copy=True) for s, d in local]
    fields = [shard(f, mesh) for f in x]
    return [tuple(f[i] for f in fields) for i in range(len(local))]


def unshard(blocks, device=None, mesh=None):
    """The inverse of `shard`: blocks joined on `device` (None = the
    device of block 0). A dataclass of [E, ...] tensors (an EdgeState, a
    ShapeResult) is joined field by field. With a multi-process `mesh`
    the blocks are this process's shards and the call is a collective:
    every rank's blocks are gathered (mesh.gather_shards), and every rank
    gets the whole."""
    from kubedtn_tpu_torch.parallel.mesh import gather_shards

    first = blocks[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: unshard([getattr(b, f.name) for b in blocks], device,
                            mesh)
            for f in dataclasses.fields(first)})
    if isinstance(first, torch.Tensor):
        if mesh is not None:
            blocks = gather_shards(mesh, blocks)
        dev = blocks[0].device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in blocks])
    return tuple(unshard([b[i] for b in blocks], device, mesh)
                 for i in range(len(first)))


def tiled_state_from_numpy(d: dict, device=None) -> TiledShapeState:
    """TiledShapeState from the numpy fields of a JAX TiledShapeState
    (props/corr [C, R, 128], vectors [R, 128]) plus its `capacity`:
    `x.reshape(C, -1)[:, :E]` drops the TPU tiles' padding."""
    dev = resolve_device(device)
    E = int(d["capacity"])

    def col(name, dtype=torch.float32):
        x = np.asarray(d[name])
        x = x.reshape(x.shape[0], -1)[:, :E] if x.ndim == 3 \
            else x.reshape(-1)[:E]
        return torch.as_tensor(np.array(x), dtype=dtype, device=dev)

    return TiledShapeState(props=col("props"), corr=col("corr"),
                           tokens=col("tokens"), t_last=col("t_last"),
                           backlog=col("backlog"),
                           count=col("count", torch.int32))
