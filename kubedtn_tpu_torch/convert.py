"""Carry state between the JAX package and this one through numpy.

The edge state is this system's "weights": with these functions the JAX
package and the port are fed one and the same state. A JAX state is
handed over as `{field: np.asarray(getattr(jax_state, field))}`, so this
module needs neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.ops import edge_state as es
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
    s on mesh[s]: a tensor gives a list of tensors, a tuple of tensors
    (the dynamic columns) a list of per-shard tuples, an EdgeState a
    list of per-shard EdgeStates."""
    from kubedtn_tpu_torch.parallel.mesh import shard_edge_state

    if isinstance(x, es.EdgeState):
        return shard_edge_state(x, mesh)
    if isinstance(x, torch.Tensor):
        n = len(mesh)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows not divisible by {n} "
                             "shards")
        return [b.to(d, copy=True)
                for b, d in zip(x.split(x.shape[0] // n), mesh)]
    fields = [shard(f, mesh) for f in x]
    return [tuple(f[s] for f in fields) for s in range(len(mesh))]


def unshard(blocks, device=None):
    """The inverse of `shard`: blocks joined on `device` (None = the
    device of block 0)."""
    first = blocks[0]
    if isinstance(first, es.EdgeState):
        return es.EdgeState(**{
            f.name: unshard([getattr(b, f.name) for b in blocks], device)
            for f in dataclasses.fields(es.EdgeState)})
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in blocks])
    return tuple(unshard([b[i] for b in blocks], device)
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
