"""netem + TBF shaping as plain tensor code over every edge at once.

Port of the single-step path of kubedtn_tpu/ops/netem.py. The reference
shapes each veth end with a Linux netem qdisc at the root and a TBF qdisc
as its child (reference common/qdisc.go:94-126, 239-272). Each function
here takes one row per edge and computes the kernel semantics of that
chain for one packet per edge, written out over the edge dimension (the
JAX package vmaps a per-packet function instead):

- netem stage (sch_netem enqueue order): duplicate -> loss -> corrupt ->
  delay/jitter -> reorder/gap, each draw AR(1)-correlated by `crandom`.
- TBF stage: token bucket with burst = max(rate/250, 5000) bytes refilled
  at rate bytes/µs; packets whose queue wait would exceed the fixed 50 ms
  qdisc latency are dropped (common/qdisc.go:264, 360-370).

All times are float32 microseconds relative to the current step's start;
`roll_epoch` shifts the time-carrying state back each step.

The hand-written CUDA kernel of the drop-in step lives in
kubedtn_tpu_torch/ops/cuda/shaping.py; `shape_step_auto` and
`shape_step_nodonate` launch it for CUDA tensors and run this module's
plain version for CPU tensors.

The live tick's ROW CORES follow (`shape_rows_indep`, `shape_rows_seq`,
`shape_rows_tbf`): each shapes K packet slots on R pre-gathered rows, and
the `shape_slots_*_nodonate` wrappers gather from the full EdgeState and
scatter the write-back. Padding rows carry index E: gathers clamp to row
E-1 and scatters drop them (JAX's out-of-bounds semantics; torch raises
on an out-of-bounds index, so the scatters write into one extra row E
that is cut off — no host sync).

KEYED DRAWS. Every (row, slot) cell takes its NU uniforms from
Philox4x32-10 (ops/cuda/philox.py) under the tick key, with the counter
(key-id lo word, key-id hi word, slot, class*2 + block): block 0 gives
lanes 0-3, block 1's first word lane 4. A cell's stream then depends on
(tick key, class, link identity, slot) only, never on which other rows
share the batch or how it is padded — the multi-tenant property of the
JAX package's fold_in draws. The bits are not threefry's: every core
takes an optional `u` ([R, K, NU] float32) that it uses instead of
drawing, which is how the tests feed both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from kubedtn_tpu_torch.api.parsers import TBF_LATENCY_US
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops.edge_state import (
    C_CORRUPT,
    C_DELAY,
    C_DUP,
    C_LOSS,
    C_REORDER,
    P_CORRUPT_CORR,
    P_CORRUPT_PROB,
    P_DUPLICATE,
    P_DUPLICATE_CORR,
    P_GAP,
    P_JITTER_US,
    P_LATENCY_CORR,
    P_LATENCY_US,
    P_LOSS,
    P_LOSS_CORR,
    P_RATE_BPS,
    P_REORDER_CORR,
    P_REORDER_PROB,
    EdgeState,
    burst_bytes,
)

# tc "latency 50ms" (common/qdisc.go:264), shared with the control plane.
TBF_QUEUE_LATENCY_US = float(TBF_LATENCY_US)

# bytes/µs per bit/s, as the compiled JAX program computes rate / 8e6
# (see edge_state.INV_250).
INV_8E6 = float(np.float32(1.0) / np.float32(8e6))

# Uniform-draw lanes per packet.
U_LOSS = 0
U_DUP = 1
U_CORRUPT = 2
U_REORDER = 3
U_DELAY = 4
NU = 5


@dataclasses.dataclass(frozen=True)
class ShapeResult:
    """Per-packet shaping outcome (times µs relative to step start)."""

    depart_us: torch.Tensor   # egress time; +inf when dropped
    delivered: torch.Tensor   # bool — left the qdisc chain
    dropped_loss: torch.Tensor    # bool — netem loss
    dropped_queue: torch.Tensor   # bool — TBF queue overflow
    corrupted: torch.Tensor   # bool — delivered but corrupted
    duplicated: torch.Tensor  # bool — a copy should be enqueued
    reordered: torch.Tensor   # bool — jumped the delay line


def cause_codes(res: ShapeResult) -> torch.Tensor:
    """Per-slot outcome taxonomy as one uint8 code: 0 = invalid/padding
    lane, 1 = delivered, 2 = netem loss, 3 = TBF queue overflow. The three
    outcome masks are mutually exclusive by construction, so the weighted
    sum is exact."""
    return (res.delivered.to(torch.uint8)
            + res.dropped_loss.to(torch.uint8) * 2
            + res.dropped_queue.to(torch.uint8) * 3)


def crandom(u: torch.Tensor, last: torch.Tensor, rho: torch.Tensor):
    """netem get_crandom: AR(1)-blended uniform in [0,1).

    `u` fresh uniform, `last` previous output, `rho` in [0,1]. When rho==0
    the state passes through unchanged (kernel skips the store).
    """
    val = u * (1.0 - rho) + last * rho
    return val, torch.where(rho > 0.0, val, last)


def netem_packet(props: torch.Tensor, corr: torch.Tensor,
                 pkt_count: torch.Tensor, u: torch.Tensor):
    """netem enqueue for one packet on every edge.

    Args:
      props: float32[E, NPROP] property rows.
      corr: float32[E, NCORR] correlated-uniform memory.
      pkt_count: int32[E] packets-since-reorder counter.
      u: float32[E, NU] fresh uniforms.

    Returns:
      (delay_us, dropped, duplicated, corrupted, reordered, corr',
       pkt_count')
    """
    latency = props[:, P_LATENCY_US]
    jitter = props[:, P_JITTER_US]
    loss = props[:, P_LOSS]
    dup = props[:, P_DUPLICATE]
    corrupt = props[:, P_CORRUPT_PROB]
    reorder = props[:, P_REORDER_PROB]
    gap = props[:, P_GAP].to(torch.int32)

    pct = 1.0 / 100.0

    # 1. duplicate, then loss — kernel order (a packet that triggers BOTH
    #    is transmitted exactly once). Both streams advance first.
    x_dup, dup_state = crandom(u[:, U_DUP], corr[:, C_DUP],
                               props[:, P_DUPLICATE_CORR] * pct)
    dup_hit = (dup > 0.0) & (x_dup * 100.0 < dup)
    dup_state = torch.where(dup > 0.0, dup_state, corr[:, C_DUP])

    x_loss, loss_state = crandom(u[:, U_LOSS], corr[:, C_LOSS],
                                 props[:, P_LOSS_CORR] * pct)
    loss_hit = (loss > 0.0) & (x_loss * 100.0 < loss)
    loss_state = torch.where(loss > 0.0, loss_state, corr[:, C_LOSS])

    dropped = loss_hit & ~dup_hit      # count 1-1 == 0
    duplicated = dup_hit & ~loss_hit   # count 1+1 == 2
    # A dropped packet early-returns in the kernel: corrupt/delay/reorder
    # randomness and the gap counter are never touched for it.
    survives = ~dropped

    # 2. corrupt
    x_cor, cor_state = crandom(u[:, U_CORRUPT], corr[:, C_CORRUPT],
                               props[:, P_CORRUPT_CORR] * pct)
    corrupted = (corrupt > 0.0) & (x_cor * 100.0 < corrupt) & survives
    cor_state = torch.where((corrupt > 0.0) & survives, cor_state,
                            corr[:, C_CORRUPT])

    # 3. delay with jitter (uniform tabledist); the delay state advances
    #    only when jitter != 0.
    x_del, del_state = crandom(u[:, U_DELAY], corr[:, C_DELAY],
                               props[:, P_LATENCY_CORR] * pct)
    delay = torch.where(jitter > 0.0,
                        latency + jitter * (2.0 * x_del - 1.0), latency)
    delay = torch.clamp_min(delay, 0.0)
    del_state = torch.where((jitter > 0.0) & survives, del_state,
                            corr[:, C_DELAY])

    # 4. reorder/gap: gap==0 means every packet is a candidate (netlink's
    #    NewNetem normalises gap to 1 when reorder is set); the reorder
    #    stream advances for candidates only.
    x_reo, reo_state = crandom(u[:, U_REORDER], corr[:, C_REORDER],
                               props[:, P_REORDER_CORR] * pct)
    reorder_on = reorder > 0.0
    candidate = (gap == 0) | (pkt_count >= gap - 1)
    do_reorder = (reorder_on & candidate & (x_reo * 100.0 <= reorder)
                  & survives)
    reo_state = torch.where(reorder_on & candidate & survives, reo_state,
                            corr[:, C_REORDER])

    delay = torch.where(do_reorder, 0.0, delay)
    new_count = torch.where(do_reorder, 0,
                            torch.where(survives, pkt_count + 1, pkt_count))

    cols = [None] * es.NCORR
    cols[C_LOSS] = loss_state
    cols[C_DUP] = dup_state
    cols[C_CORRUPT] = cor_state
    cols[C_DELAY] = del_state
    cols[C_REORDER] = reo_state
    new_corr = torch.stack(cols, dim=1)
    return delay, dropped, duplicated, corrupted, do_reorder, new_corr, \
        new_count


def tbf_packet(rate_bps: torch.Tensor, tokens: torch.Tensor,
               t_last: torch.Tensor, next_free: torch.Tensor,
               size_bytes: torch.Tensor, t_ready: torch.Tensor):
    """TBF dequeue for one packet per edge: token bucket + 50ms queue
    limit. rate 0 disables shaping (the reference only installs TBF when
    rate != 0 — common/qdisc.go:115-123).

    Returns (t_depart, dropped_queue, tokens', t_last', next_free')."""
    rate_on = rate_bps > 0.0
    rate_b_us = rate_bps * INV_8E6  # bytes per µs
    burst = burst_bytes(rate_bps)

    start = torch.maximum(t_ready, next_free)
    avail = torch.minimum(burst, tokens + (start - t_last) *
                          torch.where(rate_on, rate_b_us, 0.0))
    need = size_bytes - avail
    wait = torch.where(need > 0.0,
                       need / torch.clamp_min(rate_b_us, 1e-30), 0.0)
    depart = start + wait

    # tc latency 50ms == max time a packet may sit in the TBF queue.
    dropped = rate_on & ((depart - t_ready) > TBF_QUEUE_LATENCY_US)

    accept = rate_on & ~dropped
    new_tokens = torch.where(accept, torch.clamp_min(avail - size_bytes, 0.0),
                             tokens)
    new_t_last = torch.where(accept, depart, t_last)
    new_next_free = torch.where(accept, depart, next_free)

    t_depart = torch.where(rate_on, depart, t_ready)
    return t_depart, dropped, new_tokens, new_t_last, new_next_free


def shape_packet(props, tokens, t_last, next_free, corr, pkt_count,
                 size_bytes, t_arrival, u):
    """Full qdisc chain (netem root -> TBF child), one packet per edge.

    Returns (ShapeResult, tokens', t_last', next_free', corr',
    pkt_count')."""
    (delay, drop_loss, duplicated, corrupted, reordered,
     new_corr, new_count) = netem_packet(props, corr, pkt_count, u)

    t_ready = t_arrival + delay
    t_depart, drop_q, tk, tl, nf = tbf_packet(
        props[:, P_RATE_BPS], tokens, t_last, next_free, size_bytes, t_ready)

    # A netem-dropped packet never reaches TBF: suppress its bucket effects.
    tk = torch.where(drop_loss, tokens, tk)
    tl = torch.where(drop_loss, t_last, tl)
    nf = torch.where(drop_loss, next_free, nf)
    drop_q = drop_q & ~drop_loss

    delivered = ~drop_loss & ~drop_q
    result = ShapeResult(
        depart_us=torch.where(delivered, t_depart, torch.inf),
        delivered=delivered,
        dropped_loss=drop_loss,
        dropped_queue=drop_q,
        corrupted=corrupted & delivered,
        duplicated=duplicated & delivered,
        reordered=reordered & delivered,
    )
    return result, tk, tl, nf, new_corr, new_count


def shape_rows(props, corr, tokens, t_last, next_free, pkt_count,
               sizes, t_arrival, act, u):
    """shape_packet on every row, then the lane mask: rows where `act`
    is False report nothing and keep their state. Row-indexed views of
    any strides work, so the column-major state of ops/cuda/shaping.py
    goes through here as `props.T` / `corr.T` / `u.T`.

    Returns (ShapeResult, (tokens', t_last', next_free', corr',
    pkt_count'))."""
    res, tk, tl, nf, c, cnt = shape_packet(
        props, tokens, t_last, next_free, corr, pkt_count, sizes,
        t_arrival, u)

    def keep(new, old):
        return torch.where(act, new, old)

    state = (keep(tk, tokens), keep(tl, t_last), keep(nf, next_free),
             torch.where(act[:, None], c, corr), keep(cnt, pkt_count))
    return _mask_result(res, act), state


def _shape_step_from_u(state: EdgeState, sizes: torch.Tensor,
                       have_pkt: torch.Tensor, t_arrival: torch.Tensor,
                       u: torch.Tensor):
    """shape_step past the uniform draw: u is float32[E, NU]. The plain
    version of kernel K1 (ops/cuda/shaping.py). Returns a NEW state and
    leaves the input untouched.

    Returns: (state', ShapeResult[E]) — lanes without a packet report
      delivered=False and leave state untouched."""
    res, (tk, tl, nf, corr, cnt) = shape_rows(
        state.props, state.corr, state.tokens, state.t_last,
        state.backlog_until, state.pkt_count, sizes, t_arrival,
        have_pkt & state.active, u)
    new_state = dataclasses.replace(
        state, tokens=tk, t_last=tl, backlog_until=nf, corr=corr,
        pkt_count=cnt)
    return new_state, res


def _draw(state: EdgeState, generator: torch.Generator) -> torch.Tensor:
    return torch.rand((state.capacity, NU), generator=generator,
                      dtype=torch.float32, device=state.device)


def shape_step(state: EdgeState, sizes: torch.Tensor,
               have_pkt: torch.Tensor, t_arrival: torch.Tensor,
               generator: torch.Generator):
    """Advance every edge by one packet slot in plain tensor code.

    Args:
      state: EdgeState (not modified).
      sizes: float32[E] packet bytes per edge.
      have_pkt: bool[E] — which edges carry a packet this call.
      t_arrival: float32[E] arrival times (µs, step-relative).
      generator: torch.Generator on the state's device; [E, NU]
        uniforms are drawn from it.

    Returns: (state', ShapeResult[E])."""
    return _shape_step_from_u(state, sizes, have_pkt, t_arrival,
                              _draw(state, generator))


def shape_step_auto(state: EdgeState, sizes: torch.Tensor,
                    have_pkt: torch.Tensor, t_arrival: torch.Tensor,
                    generator: torch.Generator):
    """shape_step through kernel K1 on the card (the plain version for
    CPU tensors). Same draws from `generator` as shape_step.

    DONATES `state`: on the card the kernel writes the new shaping state
    into its tensors in place. Callers replace every reference to the
    input afterwards; concurrent holders use shape_step_nodonate."""
    from kubedtn_tpu_torch.ops.cuda import shaping

    return shaping.shape_step(state, sizes, have_pkt, t_arrival,
                              _draw(state, generator), donate=True)


def shape_step_nodonate(state: EdgeState, sizes: torch.Tensor,
                        have_pkt: torch.Tensor, t_arrival: torch.Tensor,
                        generator: torch.Generator):
    """shape_step_auto without donation: the input tensors stay valid
    and the kernel writes fresh outputs."""
    from kubedtn_tpu_torch.ops.cuda import shaping

    return shaping.shape_step(state, sizes, have_pkt, t_arrival,
                              _draw(state, generator), donate=False)


def slot_independent_rows(props):
    """bool[E]: rows whose per-packet shaping decisions never read state
    written by an earlier packet of the same batch: no TBF child
    (rate==0), no AR(1) correlation and no reorder. Works on numpy
    arrays or tensors."""
    return (props[:, es.P_RATE_BPS] == 0) & _iid_random_rows(props)


def _iid_random_rows(props):
    """Rows whose netem randomness is iid across a batch: every AR(1)
    correlation is zero and reorder (the gap counter's only consumer)
    is off."""
    return ((props[:, es.P_LATENCY_CORR] == 0)
            & (props[:, es.P_LOSS_CORR] == 0)
            & (props[:, es.P_DUPLICATE_CORR] == 0)
            & (props[:, es.P_CORRUPT_CORR] == 0)
            & (props[:, es.P_REORDER_CORR] == 0)
            & (props[:, es.P_REORDER_PROB] == 0))


def tbf_batch_rows(props):
    """Rows whose whole batch can take the exact max-plus TBF core
    (shape_rows_tbf): a real rate limit and no other cross-slot state.
    Disjoint from slot_independent_rows; the complement keeps the
    sequential core. Works on numpy arrays or tensors."""
    return (props[:, es.P_RATE_BPS] > 0) & _iid_random_rows(props)


def roll_epoch(state: EdgeState, dt_us, floor_us: float = -1e7
               ) -> EdgeState:
    """Shift step-relative clocks back by `dt_us` at the end of a step so
    times stay small and f32-exact over unbounded simulated time.
    Returns a new state; the input's tensors are not modified."""
    return dataclasses.replace(
        state,
        t_last=torch.clamp_min(state.t_last - dt_us, floor_us),
        backlog_until=torch.clamp_min(state.backlog_until - dt_us,
                                      floor_us),
    )


# roll_epoch never donates here: the input's tensors stay valid.
roll_epoch_nodonate = roll_epoch


# -- keyed draws ---------------------------------------------------------

# the per-class constants of the live tick (the JAX runtime's fold_in
# constants): they enter the Philox counter as class*2 + block
CLASS_SEQ = 0
CLASS_IND = 1
CLASS_TBF = 2


def row_keys(key_ids, R: int, device) -> tuple:
    """(lo, hi) int64 [R] counter words of each row's stable identity:
    `key_ids` [R, 2] holds the two uint32 words of the 64-bit link key id
    (in any integer dtype); None keys each row by its batch position."""
    if key_ids is None:
        lo = torch.arange(R, dtype=torch.int64, device=device)
        return lo, torch.zeros_like(lo)
    k = torch.as_tensor(key_ids, device=device).to(torch.int64)
    return k[:, 0] & 0xFFFFFFFF, k[:, 1] & 0xFFFFFFFF


def uniform_rows(key, cls: int, key_ids, R: int, K: int,
                 device) -> torch.Tensor:
    """[R, K, NU] float32 uniforms of the keyed draw (module docstring):
    Philox4x32-10 under `key` (two uint32 words) with the counter
    (id lo, id hi, slot, cls*2 + block)."""
    from kubedtn_tpu_torch.ops.cuda import philox

    lo, hi = row_keys(key_ids, R, device)
    slot = torch.arange(K, dtype=torch.int64, device=device)
    block = torch.tensor([2 * cls, 2 * cls + 1], dtype=torch.int64,
                         device=device)
    w = philox.philox4x32((lo[:, None, None], hi[:, None, None],
                           slot[None, :, None], block[None, None, :]), key)
    lanes = [w[0][..., 0], w[1][..., 0], w[2][..., 0], w[3][..., 0],
             w[0][..., 1]][:NU]
    return torch.stack([philox.bits_to_uniform(x) for x in lanes], dim=-1)


def _cell_uniforms(u, key, cls, key_ids, R, K, device):
    if u is not None:
        if tuple(u.shape) != (R, K, NU):
            raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                             f"{(R, K, NU)}")
        return u
    return uniform_rows(key, cls, key_ids, R, K, device)


# -- row cores -----------------------------------------------------------

def _mask_result(res: ShapeResult, act: torch.Tensor) -> ShapeResult:
    """Lanes where `act` is False report nothing (depart +inf)."""
    return ShapeResult(
        depart_us=torch.where(act, res.depart_us, torch.inf),
        delivered=res.delivered & act,
        dropped_loss=res.dropped_loss & act,
        dropped_queue=res.dropped_queue & act,
        corrupted=res.corrupted & act,
        duplicated=res.duplicated & act,
        reordered=res.reordered & act,
    )


def _map_result(res: ShapeResult, fn) -> ShapeResult:
    return ShapeResult(**{f.name: fn(getattr(res, f.name))
                          for f in dataclasses.fields(ShapeResult)})


def _per_cell(x: torch.Tensor, K: int) -> torch.Tensor:
    """[R, ...] row values repeated over K slots as [R*K, ...] rows."""
    return x.repeat_interleave(K, dim=0)


def shape_rows_indep(props_rows, active_rows, sizes, valid, key,
                     key_ids=None, *, u=None):
    """Slot-independent class core over pre-gathered rows: every slot
    sees zero state (the class predicate guarantees no state is read).
    Returns (ShapeResult[R, K], delta_count int32[R]): the pkt_count
    increments the caller scatter-adds."""
    R, K = sizes.shape
    dev = sizes.device
    u = _cell_uniforms(u, key, CLASS_IND, key_ids, R, K, dev)
    n = R * K
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    res, *_ = shape_packet(
        _per_cell(props_rows, K), zeros, zeros, zeros,
        torch.zeros((n, es.NCORR), dtype=torch.float32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        sizes.reshape(n), zeros, u.reshape(n, NU))
    act = valid & active_rows[:, None]
    res = _mask_result(_map_result(res, lambda x: x.reshape(R, K)), act)
    delta = (act & ~res.dropped_loss).sum(dim=1).to(torch.int32)
    return res, delta


def shape_rows_seq(props_rows, active_rows, carry0, sizes, valid, key,
                   key_ids=None, *, u=None):
    """Sequential (correlated / reorder) class core over pre-gathered
    rows: a loop over the K slots, each one `shape_rows` step; a slot
    whose lane is not `valid & active` keeps the row's state. `carry0` =
    (tokens[R], t_last[R], backlog[R], corr[R, NCORR], pkt_count[R]).
    Returns (carry', ShapeResult[R, K])."""
    R, K = sizes.shape
    dev = sizes.device
    u = _cell_uniforms(u, key, CLASS_SEQ, key_ids, R, K, dev)
    t_arr = torch.zeros(R, dtype=torch.float32, device=dev)
    tk, tl, nf, corr, cnt = carry0
    slots = []
    for k in range(K):
        res, (tk, tl, nf, corr, cnt) = shape_rows(
            props_rows, corr, tk, tl, nf, cnt, sizes[:, k], t_arr,
            valid[:, k] & active_rows, u[:, k])
        slots.append(res)
    res = ShapeResult(**{
        f.name: torch.stack([getattr(r, f.name) for r in slots], dim=1)
        for f in dataclasses.fields(ShapeResult)})
    return (tk, tl, nf, corr, cnt), res


# -inf surrogate of the (max, +) semiring: a true -inf would give
# inf - inf = nan under the affine adds; -1e30 absorbs every real operand
# (|values| < 1e10) and stays finite in float32
_MP_NEG = -1e30


def _mp_combine(x, y):
    """Compose two affine max-plus maps (y after x), elementwise."""
    xa11, xa12, xa21, xa22, xc1, xc2 = x
    ya11, ya12, ya21, ya22, yc1, yc2 = y
    mx = torch.maximum
    return (
        mx(ya11 + xa11, ya12 + xa21),
        mx(ya11 + xa12, ya12 + xa22),
        mx(ya21 + xa11, ya22 + xa21),
        mx(ya21 + xa12, ya22 + xa22),
        mx(mx(ya11 + xc1, ya12 + xc2), yc1),
        mx(mx(ya21 + xc1, ya22 + xc2), yc2),
    )


def shape_rows_tbf(props_rows, active_rows, corr_rows, cnt_rows,
                   tokens_rows, t_last_rows, backlog_rows, sizes, valid,
                   key, key_ids=None, *, u=None):
    """Exact max-plus TBF class core over pre-gathered rows.

    With V = t_depart - tokens/rate, service time q = size/rate and
    burst credit b = burst/rate (µs), tbf_packet's recurrence is affine
    in the (max, +) semiring on x = (depart, V):

        A_i = [[max(0, q_i-b), q_i], [q_i-b, q_i]]
        c_i = [t_ready_i + max(0, q_i-b), t_ready_i + q_i - b]

    and the K slots compose in one associative scan (ops/scan.py, JAX's
    pairing order). Slots that never reach the bucket carry the identity
    map. The 50 ms queue drop breaks linearity: rows where the no-drop
    run shows any queue drop are flagged in `fallback` for the exact
    sequential re-shape (the host plane's work).

    Returns (res ShapeResult[R, K], tok_row f32[R], dep_row f32[R],
    delta_count i32[R], has_accept bool[R], fallback bool[R])."""
    from kubedtn_tpu_torch.ops.scan import associative_scan

    R, K = sizes.shape
    dev = sizes.device
    u = _cell_uniforms(u, key, CLASS_TBF, key_ids, R, K, dev)
    n = R * K
    delay, loss, dup, corrupt, reorder, _corr, _cnt = netem_packet(
        _per_cell(props_rows, K), _per_cell(corr_rows, K),
        _per_cell(cnt_rows, K), u.reshape(n, NU))
    delay, loss, dup, corrupt, reorder = (
        x.reshape(R, K) for x in (delay, loss, dup, corrupt, reorder))
    act = valid & active_rows[:, None]
    live = act & ~loss
    t_ready = delay

    rate = props_rows[:, P_RATE_BPS]
    r_us = rate * INV_8E6
    q = sizes / r_us[:, None]
    b = burst_bytes(rate)[:, None] / r_us[:, None]
    neg = _MP_NEG
    qb = q - b
    qb0 = torch.clamp_min(qb, 0.0)
    a11 = torch.where(live, qb0, 0.0)
    a12 = torch.where(live, q, neg)
    a21 = torch.where(live, qb, neg)
    a22 = torch.where(live, q, 0.0)
    c1 = torch.where(live, t_ready + qb0, neg)
    c2 = torch.where(live, t_ready + qb, neg)

    pa11, pa12, pa21, pa22, pc1, pc2 = associative_scan(
        _mp_combine, (a11, a12, a21, a22, c1, c2), axis=1)
    x1_0 = backlog_rows[:, None]
    x2_0 = (t_last_rows - tokens_rows / r_us)[:, None]
    mx = torch.maximum
    dep = mx(mx(pa11 + x1_0, pa12 + x2_0), pc1)
    v = mx(mx(pa21 + x1_0, pa22 + x2_0), pc2)

    drop_q = live & (dep - t_ready > TBF_QUEUE_LATENCY_US)
    fallback = drop_q.any(dim=1)
    delivered = live & ~drop_q
    res = ShapeResult(
        depart_us=torch.where(delivered, dep, torch.inf),
        delivered=delivered,
        dropped_loss=loss & act,
        dropped_queue=drop_q,
        corrupted=corrupt & delivered,
        duplicated=dup & delivered,
        reordered=reorder & delivered,
    )
    dep_row = dep[:, -1]
    tok_row = torch.minimum(
        torch.clamp_min((dep_row - v[:, -1]) * r_us, 0.0),
        burst_bytes(rate))
    delta = live.sum(dim=1).to(torch.int32)
    has_accept = live.any(dim=1)
    return res, tok_row, dep_row, delta, has_accept, fallback


# -- gathered-row wrappers ------------------------------------------------

def gather_rows(col: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """col[rows] with the indices clamped to the last row, as a JAX
    gather clamps (padding rows carry index E)."""
    return col.index_select(0, rows.long().clamp_max(col.shape[0] - 1))


def scatter_rows(col: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
                 add: bool = False) -> torch.Tensor:
    """A NEW copy of `col` with `vals` written (or, with add=True,
    added) at `rows`; indices >= len(col) are dropped, as JAX's
    mode="drop" drops them. The extra-row trick: scatter into a copy one
    row longer, whose last row takes every padding lane, and cut it
    off. Rows other than padding must be unique (the add is then one
    add per row, exact whatever order the device's atomics take)."""
    n = col.shape[0]
    t = rows.long().clamp_max(n)
    buf = torch.cat([col, col[:1]])
    vals = vals.to(col.dtype)
    if add:
        buf.index_add_(0, t, vals)
    else:
        buf.index_copy_(0, t, vals)
    return buf[:n]


def shape_slots_indep_nodonate(state: EdgeState, row_idx, sizes, valid,
                               key, key_ids=None, *, u=None):
    """shape_rows_indep on the rows `row_idx` of `state` (only rows that
    satisfy slot_independent_rows). Returns (ShapeResult[R, K],
    new_pkt_count int32[E]): pkt_count is the only state this class
    advances. `state` is not modified."""
    res, delta = shape_rows_indep(
        gather_rows(state.props, row_idx), gather_rows(state.active,
                                                        row_idx),
        sizes, valid, key, key_ids, u=u)
    return res, scatter_rows(state.pkt_count, row_idx, delta, add=True)


def shape_slots_tbf_nodonate(state: EdgeState, row_idx, sizes, valid,
                             key, key_ids=None, *, u=None):
    """shape_rows_tbf on the rows `row_idx` of `state` (rows that satisfy
    tbf_batch_rows). Returns (res, tok_row, dep_row, delta_count,
    has_accept, fallback): the caller writes tokens=tok_row,
    t_last=backlog_until=dep_row and pkt_count += delta_count for rows
    with has_accept & ~fallback. `state` is not modified."""
    g = functools.partial(gather_rows, rows=row_idx)
    return shape_rows_tbf(
        g(state.props), g(state.active), g(state.corr), g(state.pkt_count),
        g(state.tokens), g(state.t_last), g(state.backlog_until), sizes,
        valid, key, key_ids, u=u)


def shape_slots_nodonate(state: EdgeState, row_idx, sizes, valid, key,
                         key_ids=None, *, u=None):
    """shape_rows_seq on the rows `row_idx` of `state`: the exact path for
    rows with cross-slot state. Returns (state', ShapeResult[R, K]) —
    state' a NEW full-capacity state with the rows' dynamic columns
    advanced; `state` is not modified."""
    g = functools.partial(gather_rows, rows=row_idx)
    carry0 = (g(state.tokens), g(state.t_last), g(state.backlog_until),
              g(state.corr), g(state.pkt_count))
    (tk, tl, nf, corr, cnt), res = shape_rows_seq(
        g(state.props), g(state.active), carry0, sizes, valid, key,
        key_ids, u=u)
    new_state = dataclasses.replace(
        state,
        tokens=scatter_rows(state.tokens, row_idx, tk),
        t_last=scatter_rows(state.t_last, row_idx, tl),
        backlog_until=scatter_rows(state.backlog_until, row_idx, nf),
        corr=scatter_rows(state.corr, row_idx, corr),
        pkt_count=scatter_rows(state.pkt_count, row_idx, cnt))
    return new_state, res
