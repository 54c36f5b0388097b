"""EdgeState — the entire topology as structure-of-arrays device state.

Port of kubedtn_tpu/ops/edge_state.py. Every *directed* link is one row
of capacity-padded tensors: a p2p link appears once per endpoint
topology (same uid, two directions), and each row models that
endpoint's egress netem -> TBF qdisc chain (reference
common/veth.go:44-62, common/qdisc.go:201-290).

Design notes:
- Static capacity, `active` mask, free-list managed on host: churn never
  changes tensor shapes.
- Shaping properties live in one float32 [E, NPROP] matrix so a batched
  property update is one scatter per field — the `link-updates/sec` hot
  path.
- The JAX package donates the state to its batch ops; here the batch ops
  update the state's tensors IN PLACE and return the same object, which
  is the same contract (callers replace every reference to the input).
- JAX scatters padded lanes out of bounds with mode="drop"; torch raises
  on an out-of-bounds index, so the padding lanes are masked out first.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device

# Property-matrix column indices (order mirrors the LinkProperties fields,
# reference api/v1/topology_types.go:119-176 / proto/v1 LinkProperties).
P_LATENCY_US = 0
P_LATENCY_CORR = 1
P_JITTER_US = 2
P_LOSS = 3
P_LOSS_CORR = 4
P_RATE_BPS = 5
P_GAP = 6
P_DUPLICATE = 7
P_DUPLICATE_CORR = 8
P_REORDER_PROB = 9
P_REORDER_CORR = 10
P_CORRUPT_PROB = 11
P_CORRUPT_CORR = 12
NPROP = 13

PROP_NAMES = (
    "latency_us", "latency_corr", "jitter_us", "loss", "loss_corr",
    "rate_bps", "gap", "duplicate", "duplicate_corr",
    "reorder_prob", "reorder_corr", "corrupt_prob", "corrupt_corr",
)

# Correlated-uniform memory slots (netem keeps one AR(1) state per
# correlated property; see kubedtn_tpu_torch.ops.netem).
C_DELAY = 0
C_LOSS = 1
C_DUP = 2
C_REORDER = 3
C_CORRUPT = 4
NCORR = 5


@dataclasses.dataclass(frozen=True)
class EdgeState:
    """Topology + shaping state for up to `capacity` directed edges."""

    # -- identity / graph structure ------------------------------------
    uid: torch.Tensor        # int32[E], p2p link uid; -1 on free rows
    src: torch.Tensor        # int32[E], source node index
    dst: torch.Tensor        # int32[E], destination node index
    active: torch.Tensor     # bool[E]
    # -- shaping properties (parsed LinkProperties) --------------------
    props: torch.Tensor      # float32[E, NPROP]
    # -- mutable shaping state -----------------------------------------
    tokens: torch.Tensor     # float32[E], token-bucket fill in bytes
    t_last: torch.Tensor     # float32[E], time of last bucket update (µs)
    corr: torch.Tensor       # float32[E, NCORR], AR(1) memory in [0,1)
    pkt_count: torch.Tensor  # int32[E], packets seen (gap/reorder counter)
    backlog_until: torch.Tensor  # float32[E], µs when the rate queue drains

    @property
    def capacity(self) -> int:
        return self.uid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.uid.device

    @property
    def num_active(self) -> torch.Tensor:
        return self.active.sum()


def init_state(capacity: int, device=None) -> EdgeState:
    """Fresh all-free state with static `capacity` rows on `device`
    (None = the CUDA card, which must exist)."""
    dev = resolve_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EdgeState(
        uid=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        src=z(capacity, dtype=torch.int32),
        dst=z(capacity, dtype=torch.int32),
        active=z(capacity, dtype=torch.bool),
        props=z(capacity, NPROP),
        tokens=z(capacity),
        t_last=z(capacity),
        corr=z(capacity, NCORR),
        pkt_count=z(capacity, dtype=torch.int32),
        backlog_until=z(capacity),
    )


def props_row(numeric: dict) -> np.ndarray:
    """Pack a LinkProperties.to_numeric() record into one props row.

    Returns a HOST (numpy) row: per-link rows are staged on host and only
    the batched matrix crosses to the device."""
    return np.array([numeric[name] for name in PROP_NAMES], dtype=np.float32)


@functools.lru_cache(maxsize=65536)
def props_row_and_shaped(props) -> tuple[np.ndarray, bool]:
    """(props_row, shapes-traffic?) keyed by a (frozen, hashable)
    LinkProperties value — the same few property sets are packed for
    thousands of links, so both answers are memoized together. The
    returned row is shared and marked read-only; batch builders copy it
    when stacking."""
    row = props_row(props.to_numeric())
    row.flags.writeable = False
    return row, bool(row.any())


# XLA rewrites a division by a constant into a multiplication by the
# constant's float32 reciprocal, so the compiled JAX functions compute
# rate * f32(1/250) rather than rate / 250 (an ulp apart for most rates).
# The port multiplies by the same reciprocal, as do the CUDA kernels, and
# so matches the JAX package bit for bit.
INV_250 = float(np.float32(1.0) / np.float32(250.0))


def burst_bytes(rate_bps: torch.Tensor) -> torch.Tensor:
    """Token-bucket burst: max(rate/250, 5000) bytes, the reference's
    getTbfBurst rule (common/qdisc.go:360-370)."""
    return torch.clamp_min(rate_bps * INV_250, 5000.0)


def _on(x, state: EdgeState, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=state.device)


def _valid_rows(state: EdgeState, rows, valid):
    """(row indices, lane mask) of the valid lanes: the lanes JAX keeps
    after _drop_invalid sends the others out of bounds."""
    valid = _on(valid, state, torch.bool)
    rows = _on(rows, state).long()
    return rows[valid], valid


def apply_links(
    state: EdgeState,
    rows,      # int[B] target row per link
    uids,      # int32[B]
    src,       # int32[B]
    dst,       # int32[B]
    props,     # float32[B, NPROP]
    valid,     # bool[B] — padding mask for partial batches
) -> EdgeState:
    """Batched link add/replace: one scatter per field, IN PLACE on
    `state` (returned). Shaping state is reset exactly as a fresh qdisc
    install would be: full token bucket, cleared correlation memory and
    counters (reference daemon/kubedtn/handler.go:592-611, 316-459)."""
    t, v = _valid_rows(state, rows, valid)
    p = _on(props, state, torch.float32)[v]
    state.uid[t] = _on(uids, state, torch.int32)[v]
    state.src[t] = _on(src, state, torch.int32)[v]
    state.dst[t] = _on(dst, state, torch.int32)[v]
    state.active[t] = True
    state.props[t] = p
    state.tokens[t] = burst_bytes(p[:, P_RATE_BPS])
    state.t_last[t] = 0.0
    state.corr[t] = 0.0
    state.pkt_count[t] = 0
    state.backlog_until[t] = 0.0
    return state


def delete_links(state: EdgeState, rows, valid) -> EdgeState:
    """Batched link delete, IN PLACE: deactivate rows and clear identity
    (reference daemon/kubedtn/handler.go:461-492); rows return to the
    host free-list."""
    t, _ = _valid_rows(state, rows, valid)
    state.uid[t] = -1
    state.active[t] = False
    state.props[t] = 0.0
    return state


def update_links(state: EdgeState, rows, props, valid,
                 contiguous: bool = False) -> EdgeState:
    """Batched in-place property update — the `link-updates/sec` hot path.

    Equivalent of the reference's UpdateLinks qdisc rebuild
    (daemon/kubedtn/handler.go:634-671): properties replaced and shaping
    state reset. Updates `state`'s tensors IN PLACE and returns it.

    Three formulations, as in the JAX package:

    - `contiguous=True` (caller guarantees the VALID rows are
      `rows[0] + arange` and the window fits): slice views, no gather,
      no scatter. `rows[0]` is read on the host — pass `rows` as a host
      array to keep the call free of a device sync.
    - Small batches (`B*4 < capacity`): direct scatters touching only
      the B valid rows.
    - Dense batches: ONE int32 inverse map (edge row -> batch index,
      -1 = untouched) built with a single scatter, then every field
      updates through a gather and a select over the whole capacity.
    """
    B = len(rows)
    if B == 0:
        return state
    props = _on(props, state, torch.float32)
    if contiguous:
        start = int(rows[0])
        return _update_links_contiguous(state, start, props,
                                        _on(valid, state, torch.bool))
    if B * 4 < state.capacity:
        t, v = _valid_rows(state, rows, valid)
        p = props[v]
        state.props[t] = p
        state.tokens[t] = burst_bytes(p[:, P_RATE_BPS])
        state.corr[t] = 0.0
        state.pkt_count[t] = 0
        state.backlog_until[t] = 0.0
        return state
    # Padding lanes land on the extra row E, which is cut off — JAX's
    # mode="drop" without a host round trip for the mask.
    E = state.capacity
    v = _on(valid, state, torch.bool)
    t = torch.where(v, _on(rows, state).long(), E)
    inv = torch.full((E + 1,), -1, dtype=torch.int32, device=state.device)
    inv[t] = torch.arange(B, dtype=torch.int32, device=state.device)
    inv = inv[:E]
    hit = inv >= 0
    newp = props.index_select(0, torch.where(hit, inv, 0))
    col = hit[:, None]
    torch.where(col, newp, state.props, out=state.props)
    torch.where(hit, burst_bytes(newp[:, P_RATE_BPS]), state.tokens,
                out=state.tokens)
    state.corr.masked_fill_(col, 0.0)
    state.pkt_count.masked_fill_(hit, 0)
    state.backlog_until.masked_fill_(hit, 0.0)
    return state


def _update_links_contiguous(state: EdgeState, start: int,
                             props: torch.Tensor,
                             valid: torch.Tensor) -> EdgeState:
    """update_links for a batch occupying rows [start, start+B): blend
    the window's views through the valid mask in place. Invalid
    (padding) lanes keep their current values."""
    B = props.shape[0]
    if start < 0 or start + B > state.capacity:
        raise ValueError(f"contiguous window [{start}, {start + B}) is "
                         f"outside capacity {state.capacity}")
    w = slice(start, start + B)
    vcol = valid[:, None]
    win_p = state.props[w]
    torch.where(vcol, props, win_p, out=win_p)
    win_t = state.tokens[w]
    torch.where(valid, burst_bytes(win_p[:, P_RATE_BPS]), win_t, out=win_t)
    state.corr[w].masked_fill_(vcol, 0.0)
    state.pkt_count[w].masked_fill_(valid, 0)
    state.backlog_until[w].masked_fill_(valid, 0.0)
    return state


def contiguous_window(rows, valid, capacity: int) -> bool:
    """Host-side check for the contiguous fast path: every VALID lane is
    `rows[0] + lane_index` and the whole padded window fits in bounds.
    Padding lanes may hold anything (they keep current values)."""
    rows = np.asarray(rows)
    valid = np.asarray(valid)
    if rows.ndim != 1 or rows.shape[0] == 0 or not valid[0]:
        return False
    start = int(rows[0])
    if start + rows.shape[0] > capacity:
        return False
    expect = start + np.arange(rows.shape[0], dtype=rows.dtype)
    return bool(np.all(~valid | (rows == expect)))


def _fields(state: EdgeState):
    return [(f.name, getattr(state, f.name))
            for f in dataclasses.fields(EdgeState)]


def compact_state(state: EdgeState, perm, n_active) -> EdgeState:
    """Repack rows so the active set occupies [0, n_active); returns a
    NEW state.

    perm: int[capacity] — perm[i] is the OLD row landing at new row i for
    i < n_active; entries beyond n_active may be anything (their rows are
    reset to inactive/defaults). Indices are normalised and clamped like
    a JAX gather's, so no entry raises. One gather per field; the host
    remaps its registries with the same permutation."""
    E = state.capacity
    perm = _on(perm, state).long()
    perm = torch.where(perm < 0, perm + E, perm).clamp(0, E - 1)
    live = torch.arange(E, device=state.device) < int(n_active)
    fresh = init_state(E, state.device)
    out = {}
    for name, old in _fields(state):
        moved = old.index_select(0, perm)
        mask = live.reshape((-1,) + (1,) * (moved.dim() - 1))
        out[name] = torch.where(mask, moved, getattr(fresh, name))
    return EdgeState(**out)


def grow_state(state: EdgeState, new_capacity: int) -> EdgeState:
    """Reallocate at a larger static capacity (host-side, amortized);
    returns a NEW state, or `state` itself when it is already large
    enough."""
    if new_capacity <= state.capacity:
        return state
    fresh = init_state(new_capacity, state.device)
    n = state.capacity
    for name, old in _fields(state):
        getattr(fresh, name)[:n] = old
    return fresh
