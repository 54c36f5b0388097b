"""Perturbation spec — the what-if vocabulary and its compiler.

A `Scenario` is a named list of `Perturbation`s; a sweep runs one
replica per scenario (plus an implicit unperturbed baseline and any
padding replicas). Perturbation kinds:

- "degrade": replace a link's properties (both directed rows) with new
  `LinkProperties` — UpdateLinks semantics, i.e. the qdisc chain is
  reinstalled so the row's mutable shaping state resets, exactly like
  the live control plane's `update_links` batches (topology deltas are
  expressed the same way: any uid → any property set).
- "fail": deactivate a link's rows (both directions) — the hard-down
  case property emulation can't express.
- "blackhole": deactivate EVERY row touching a node (src or dst) — the
  node-death case.
- "scale": multiply the scenario's offered load (generated packet
  bytes) by `factor`; factor 1.0 is a bitwise no-op, so the baseline
  replica stays bit-identical to an unbatched run.

Compilation is host-side: each scenario's property edits and
deactivations become rows in padded [N, B]-shaped batches, applied on
device by one `update_links` scatter and one `active` clear over the
replica-major N x E rows of a sweep (kubedtn_tpu_torch.twin.engine).
Padding lanes are masked out — an empty scenario's replica is
bit-identical to the unedited base state.

Port of kubedtn_tpu/twin/spec.py; the snapshot's edge state may lie on
any device (its uid/src/dst/active columns are read on the host).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch.ops import edge_state as es

KINDS = ("degrade", "fail", "blackhole", "scale")


@dataclasses.dataclass(frozen=True)
class Perturbation:
    """One edit to a replica's universe."""

    kind: str                    # one of KINDS
    uid: int | None = None       # degrade / fail target link
    props: object | None = None  # LinkProperties for degrade
    node: object | None = None   # blackhole target: node id or pod name
    factor: float = 1.0          # scale multiplier
    # degrade only: restrict the edit to the directed row(s) whose
    # SOURCE is this node id — `update_links` semantics, which rebuild
    # only the local end's qdiscs. None (the default, and the only form
    # the wire surface emits) degrades every active row of the uid,
    # the historical both-directions behavior.
    src_node: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown perturbation kind {self.kind!r}; "
                             f"choices: {', '.join(KINDS)}")
        if self.kind in ("degrade", "fail") and self.uid is None:
            raise ValueError(f"{self.kind} perturbation needs a link uid")
        if self.kind == "degrade" and self.props is None:
            raise ValueError("degrade perturbation needs LinkProperties")
        if self.kind == "blackhole" and self.node is None:
            raise ValueError("blackhole perturbation needs a node")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named bundle of perturbations — one replica of the sweep."""

    name: str
    perturbations: tuple = ()

    @property
    def traffic_scale(self) -> float:
        s = 1.0
        for p in self.perturbations:
            if p.kind == "scale":
                s *= float(p.factor)
        return s


@dataclasses.dataclass(frozen=True)
class ReplicaEdits:
    """Compiled per-replica edit batches (host numpy, padded).

    rows/props/valid drive one `update_links` scatter over every
    replica's rows; drows/dvalid one `active`-mask clear; scale is the
    per-replica offered-load multiplier. Row 0 lanes of a scenario with
    no edits are all-invalid, which the scatters skip — a bitwise no-op.
    """

    rows: np.ndarray    # i32[N, B]
    props: np.ndarray   # f32[N, B, NPROP]
    valid: np.ndarray   # bool[N, B]
    drows: np.ndarray   # i32[N, Bd]
    dvalid: np.ndarray  # bool[N, Bd]
    scale: np.ndarray   # f32[N]

    @property
    def n_replicas(self) -> int:
        return self.rows.shape[0]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pad(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _resolve_node(node, pod_ids: dict | None) -> int:
    """Node id from an int, a pod name (engine registry lookup), or a
    digit string (the wire protocol's node field is a string, so a
    numeric id sent via `kdt whatif --daemon` arrives as "3" — the two
    query modes must resolve the same spec identically). A pod NAMED
    like a number wins over the numeric reading."""
    if isinstance(node, (int, np.integer)):
        return int(node)
    if pod_ids is not None:
        if node in pod_ids:
            return int(pod_ids[node])
        # pod keys are "ns/name": accept a bare name matching exactly one
        hits = [v for k, v in pod_ids.items()
                if k == node or k.endswith(f"/{node}")]
        if len(hits) == 1:
            return int(hits[0])
        if len(hits) > 1:
            raise ValueError(
                f"blackhole node {node!r}: ambiguous in pod registry")
    try:
        return int(str(node))
    except ValueError:
        pass
    if pod_ids is None:
        raise ValueError(
            f"blackhole node {node!r} is a name but no pod-id registry "
            f"was provided (pass ints, or compile with pod_ids=)")
    raise ValueError(f"blackhole node {node!r}: not found in pod registry")


def compile_scenarios(scenarios, edges, pod_ids: dict | None = None,
                      pad_replicas_to: int | None = None) -> ReplicaEdits:
    """Compile scenarios into padded per-replica edit batches.

    `edges` is the snapshot's EdgeState (host reads of uid/src/dst
    resolve targets); `pod_ids` the engine's endpoint→node registry for
    blackhole-by-name. `pad_replicas_to` rounds the replica count up
    with unperturbed padding replicas (sharding wants N divisible by
    the mesh size); padding replicas share the sweep's PRNG keys, so
    they cannot perturb any real replica's streams.
    """
    uid_arr = _host(edges.uid)
    active = _host(edges.active)
    src = _host(edges.src)
    dst = _host(edges.dst)
    cap = int(uid_arr.shape[0])

    per_rows: list[list[int]] = []
    per_props: list[list[np.ndarray]] = []
    per_drows: list[list[int]] = []
    scales: list[float] = []
    for sc in scenarios:
        rows_i: list[int] = []
        props_i: list[np.ndarray] = []
        drows_i: list[int] = []
        for p in sc.perturbations:
            if p.kind == "scale":
                continue
            if p.kind == "blackhole":
                nid = _resolve_node(p.node, pod_ids)
                hit = np.flatnonzero(active & ((src == nid) | (dst == nid)))
                if hit.size == 0:
                    # same contract as an unknown uid below: a silent
                    # no-op replica would rank the node's death as
                    # harmless — a wrong answer, not an empty one
                    raise ValueError(
                        f"scenario {sc.name!r}: blackhole node "
                        f"{p.node!r} (id {nid}) touches no active rows")
                drows_i.extend(int(r) for r in hit)
                continue
            mask = active & (uid_arr == int(p.uid))
            if p.kind == "degrade" and p.src_node is not None:
                mask &= src == int(p.src_node)
            hit = np.flatnonzero(mask)
            if hit.size == 0:
                raise ValueError(
                    f"scenario {sc.name!r}: no active rows for link uid "
                    f"{p.uid}"
                    + (f" with src node {p.src_node}"
                       if p.src_node is not None else ""))
            if p.kind == "fail":
                drows_i.extend(int(r) for r in hit)
            else:  # degrade
                prow, _shaped = es.props_row_and_shaped(p.props)
                for r in hit:
                    rows_i.append(int(r))
                    props_i.append(prow)
        per_rows.append(rows_i)
        per_props.append(props_i)
        per_drows.append(drows_i)
        scales.append(sc.traffic_scale)

    n = len(scenarios)
    n_pad = max(n, 1)
    if pad_replicas_to is not None:
        n_pad = max(n_pad, int(pad_replicas_to))
    b = _pad(max((len(r) for r in per_rows), default=1) or 1)
    bd = _pad(max((len(r) for r in per_drows), default=1) or 1)

    rows = np.full((n_pad, b), cap, np.int32)      # cap = dropped lane
    props = np.zeros((n_pad, b, es.NPROP), np.float32)
    valid = np.zeros((n_pad, b), bool)
    drows = np.full((n_pad, bd), cap, np.int32)
    dvalid = np.zeros((n_pad, bd), bool)
    scale = np.ones((n_pad,), np.float32)
    for i in range(n):
        m = len(per_rows[i])
        if m:
            rows[i, :m] = per_rows[i]
            props[i, :m] = np.stack(per_props[i])
            valid[i, :m] = True
        md = len(per_drows[i])
        if md:
            drows[i, :md] = per_drows[i]
            dvalid[i, :md] = True
        scale[i] = scales[i]
    return ReplicaEdits(rows=rows, props=props, valid=valid,
                       drows=drows, dvalid=dvalid, scale=scale)
