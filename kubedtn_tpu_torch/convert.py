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
