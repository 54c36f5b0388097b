"""The live tick's device program: one tick of the data plane's shaping.

Port of the device half of kubedtn_tpu/runtime.py. Each tick, the data
plane drains the frames queued on every wire, packs each kernel class's
busy rows into a padded [R, K] group (`_build_group`) and hands the
groups to ONE device program (`fused_tick`), which

- splits the tick key (the sub-key draws this tick's uniforms);
- rolls the persistent shaping clocks by the wall time since the last
  tick, so token buckets refill with real time;
- shapes the three classes in the order tbf -> seq -> ind, each on its
  row core (ops/netem.py), writing the dynamic columns back;
- folds each class's results into the link-telemetry window (optional).

`class_tick` is one class of the same program on its own, the un-fused
per-class ladder: chained tbf -> seq -> ind with the same sub-key it
gives bit for bit what `fused_tick` gives. `make_sharded_fused(mesh)`
builds the same program over an edge-sharded state: each shard rolls its
clock slice, packs its owned rows into the mailbox, the ring exchange
(parallel/exchange.py, kernel K4) assembles the batch on every shard,
each shard runs the SAME row core on it and scatters back only its owned
rows — bit for bit the unsharded program.

The HOST LIVE PLANE that drives this program follows (`WireDataPlane`,
the port of the JAX runtime's host half). Each tick it drains the wires'
ingress (wire/server.Daemon), takes the native bypass / classify
verdict for the whole drain in one call, packs the class groups, issues
ONE device program (`fused_tick`; the sharded one after
`enable_sharding`; the per-class ladder at degradation rung 2), and at
completion re-shapes the rare TBF 50 ms-queue fallback rows exactly,
writes the dynamic columns back into the engine, schedules the releases
on the native timing wheel and releases due frames to the egress wires.

On the card the pipeline keeps depth 2 for real: the group arrays go
through pinned buffers with non-blocking copies, the outputs come back
into pinned buffers behind one CUDA event per job, and `_complete`'s
wait on that event is the pipeline's only sync point. Every tensor op
of the plane and of the engine is issued on the calling thread's current
(default) stream, so an UpdateLinks scatter from a gRPC thread is
ordered after a dispatched tick that read the old props, as the JAX
package's immutable snapshots order them. The engine updates its state
IN PLACE, so the plane keys its host props mirror on the engine's
`props_gen`, gathers the TBF rows a dispatch shaped from at dispatch,
and writes back into new tensors.

The TBF fallback re-shape draws under the tick's sub-key with the class
id netem.CLASS_FALLBACK = 3, i.e. the counter blocks 6 and 7: no tick
draw uses them (class*2 + block <= 5) and neither does the split's
counter (last word 2^32 - 1).

Cross-node egress is the JAX plane's: released frames for a wire whose
peer daemon is on another node stage in a native FrameRing
(`_RemoteStage`, 4 MiB; overflow charged to the row's
`counters.dropped_ring`) and cross to each peer as one coalesced
SendToBulk stream of 256-frame PacketBatch messages per tick, sent by a
per-peer thread (`_PeerSender`) behind a circuit breaker with retry,
backoff, a bounded outage buffer and the UNIMPLEMENTED -> SendToStream
fallback for reference-built peers. `attach_chaos` wires a
chaos.ChaosInjector into the peer RPCs and the dispatch hook.

`export_pending` / `restore_pending` make the delay line checkpointable
(kubedtn_tpu_torch.checkpoint): each pending entry keeps its frames'
wheel deadlines, and a restored frame completes its REMAINING delay.
`stage_update_round` is the planned-update stager's barrier.
`attach_tenancy` wires a tenancy.TenantRegistry into the drain: every
tick resolves the registry's per-wire budget once (`drain_policy`),
drains with it and debits what was drained (`charge_drained`).
`attach_shm` wires a shm.ShmIngest into the Daemon's drain, with a
watcher thread that wakes the runner on ring traffic; the trace ids a
producer stamped into its ring slots ride the frames' FrameSeg and join
the flight recorder's samples under the same id.

THE TICK KEY is two uint32 words (Python ints, so splitting it never
touches the device). `split(key)` is one Philox4x32-10 call under `key`
on the counter (0, 0, 0, 2^32 - 1): words 0-1 are the next tick key,
words 2-3 the tick's sub-key. The row cores' draws use counters whose
last word is class*2 + block <= 5, so the split's counter never collides
with a draw's.
"""

from __future__ import annotations

import dataclasses
import gc
import struct
import threading
import time
from collections import deque

import numpy as np
import torch

from kubedtn_tpu_torch import fault, resolve_device
from kubedtn_tpu_torch import telemetry as tele
from kubedtn_tpu_torch.contracts import guarded_by, requires_lock
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.cuda import philox
from kubedtn_tpu_torch.ops.edge_state import NCORR, NPROP
from kubedtn_tpu_torch.ops.queues import EdgeCounters

# the order in which one tick shapes its classes
CLASS_ORDER = ("tbf", "seq", "ind")

SPLIT_CTR = (0, 0, 0, philox.MASK32)
CLOCK_FLOOR_US = -1e7


def tick_key(seed: int) -> tuple:
    """The first tick key of a plane seeded with `seed` (64 bits)."""
    return (int(seed) & philox.MASK32, (int(seed) >> 32) & philox.MASK32)


def split(key) -> tuple:
    """(next tick key, this tick's sub-key), both two uint32 words."""
    w = philox.philox4x32_words(SPLIT_CTR, key)
    return (w[0], w[1]), (w[2], w[3])


def _f32(x):
    """A clock offset as the device program reads it: a float32 value."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def _row_counts(res):
    """Per-row float32 sums of the loss, queue-drop and corrupt masks:
    the [R, K] masks need not leave the device, only these [R] sums."""
    f32 = torch.float32
    return (res.dropped_loss.sum(dim=1).to(f32),
            res.dropped_queue.sum(dim=1).to(f32),
            res.corrupted.sum(dim=1).to(f32))


# the dynamic columns the tick chains (everything the row cores write)
DYN_FIELDS = ("tokens", "t_last", "backlog_until", "corr", "pkt_count")
# the EdgeState columns a row core reads, in the order _class_rows takes them
ROW_FIELDS = ("props", "active") + DYN_FIELDS


def _dyn_of(state):
    return tuple(getattr(state, f) for f in DYN_FIELDS)


def _with_dyn(state, dyn):
    return dataclasses.replace(state, **dict(zip(DYN_FIELDS, dyn)))


def _roll_clocks(state, elapsed_us):
    """Advance the shaping clocks by the wall time since the last tick
    (the identity at 0): the token buckets refill before shaping."""
    el = _f32(elapsed_us)
    return dataclasses.replace(
        state,
        t_last=torch.clamp_min(state.t_last - el, CLOCK_FLOOR_US),
        backlog_until=torch.clamp_min(state.backlog_until - el,
                                      CLOCK_FLOOR_US))


def _out(res, *extra):
    """A class's out tuple: (delivered [R, K], depart_us [R, K], loss [R],
    queue [R], corrupt [R] [, fallback [R] for tbf])."""
    return (res.delivered, res.depart_us, *_row_counts(res), *extra)


def _tbf_advance(core, tokens, t_last, backlog, cnt):
    """The TBF class's write-back rule, shared by the unsharded and the
    sharded program. `core` is shape_rows_tbf's return, the rest the
    rows' current columns. Accepted, non-fallback rows advance their
    bucket state; fallback rows stay as they were (the exact re-shape
    reads them). Returns the rows' new columns by name."""
    _res, tok_row, dep_row, delta, hacc, fbk = core
    apply = hacc & ~fbk
    return {"tokens": torch.where(apply, tok_row, tokens),
            "t_last": torch.where(apply, dep_row, t_last),
            "backlog_until": torch.where(apply, dep_row, backlog),
            "pkt_count": cnt + torch.where(apply, delta, 0)}


def _class_rows(kind: str, cols, sizes, valid, sub, kids, u=None):
    """One class's row core on rows the sharded program assembled from the
    mailbox. `cols` are the rows' ROW_FIELDS columns. Returns (new, out,
    res): `new` maps each dynamic column the class advances to the rows'
    new values, `out` as `_out` builds it, `res` the full ShapeResult
    (the telemetry fold's feed)."""
    props, active, tokens, t_last, backlog, corr, cnt = cols
    if kind == "tbf":
        core = netem.shape_rows_tbf(props, active, corr, cnt, tokens, t_last,
                                    backlog, sizes, valid, sub, kids, u=u)
        return (_tbf_advance(core, tokens, t_last, backlog, cnt),
                _out(core[0], core[5]), core[0])
    if kind == "seq":
        carry, res = netem.shape_rows_seq(
            props, active, (tokens, t_last, backlog, corr, cnt), sizes,
            valid, sub, kids, u=u)
        new = dict(zip(DYN_FIELDS, carry))
    else:
        res, delta = netem.shape_rows_indep(props, active, sizes, valid,
                                            sub, kids, u=u)
        new = {"pkt_count": cnt + delta}
    return new, _out(res), res


def _shape_class(state, kind: str, args, sub, u=None):
    """One class's shaping and dynamic-state write-back, shared by
    `fused_tick` and `class_tick`, through netem's gathered-row wrappers
    (padding rows clamp on the gather and drop from the scatter). `args`
    is the (row_idx, sizes, valid, key_ids) quadruple `_build_group`
    packs; `u` optional given uniforms. Returns (state', out, res): `out`
    as `_out` builds it, `res` the full ShapeResult (the telemetry fold's
    feed)."""
    rows, sizes, valid, kids = args
    if kind == "tbf":
        core = netem.shape_slots_tbf_nodonate(state, rows, sizes, valid,
                                              sub, kids, u=u)
        old = [netem.gather_rows(getattr(state, f), rows)
               for f in ("tokens", "t_last", "backlog_until", "pkt_count")]
        new = _tbf_advance(core, *old)
        state = dataclasses.replace(state, **{
            f: netem.scatter_rows(getattr(state, f), rows, v)
            for f, v in new.items()})
        return state, _out(core[0], core[5]), core[0]
    if kind == "seq":
        state, res = netem.shape_slots_nodonate(state, rows, sizes, valid,
                                                sub, kids, u=u)
    else:
        res, cnt = netem.shape_slots_indep_nodonate(state, rows, sizes,
                                                    valid, sub, kids, u=u)
        state = dataclasses.replace(state, pkt_count=cnt)
    return state, _out(res), res


def _tel_class(tel, kind: str, args, out, res):
    """Fold one class's results into the telemetry window. TBF rows
    flagged for the fallback re-shape are left out (their results here
    are discarded; the host plane patches their stats)."""
    rows, sizes, valid = args[0], args[1], args[2]
    if kind == "tbf":
        rows = torch.where(out[5], tel.shape[0], rows)
    return tele.tel_accumulate(tel, rows, sizes, valid, res,
                               row_counts=out[2:5]), out


def _class_args(seq_args, tbf_args, ind_args):
    return [(kind, args) for kind, args in
            (("tbf", tbf_args), ("seq", seq_args), ("ind", ind_args))
            if args is not None]


def fused_tick(state, dyn, key, elapsed_us, seq_args, tbf_args, ind_args,
               tel=None, *, uniforms=None):
    """One tick's whole device program. `*_args` are `_build_group`
    quadruples or None (the class has no traffic); `dyn`, when given,
    replaces the state's dynamic columns (the previous tick's output);
    `tel`, when given, is the [E, KCOLS] telemetry window; `uniforms`
    optionally maps a class to its given [R, K, NU] uniforms. The inputs
    are not modified.

    Returns (key', sub, dyn', outs, tel') with outs[kind] as `_out`
    builds it; `sub` seeds the host's TBF fallback re-shape."""
    if dyn is not None:
        state = _with_dyn(state, dyn)
    key, sub = split(key)
    state = _roll_clocks(state, elapsed_us)
    outs = {}
    for kind, args in _class_args(seq_args, tbf_args, ind_args):
        u = uniforms.get(kind) if uniforms else None
        state, out, res = _shape_class(state, kind, args, sub, u)
        if tel is not None:
            tel, out = _tel_class(tel, kind, args, out, res)
        outs[kind] = out
    return key, sub, _dyn_of(state), outs, tel


def class_tick(state, dyn, sub, elapsed_us, args, tel=None, *, kind: str,
               u=None):
    """One class of `fused_tick` on its own: the per-class ladder. The
    caller chains the classes tbf -> seq -> ind with `dyn` carrying each
    class's write-back and the SAME `sub`; `elapsed_us` is the tick's
    clock roll on the first class and 0 on the rest. Returns
    (dyn', out, tel')."""
    if dyn is not None:
        state = _with_dyn(state, dyn)
    state = _roll_clocks(state, elapsed_us)
    state, out, res = _shape_class(state, kind, args, sub, u)
    if tel is not None:
        tel, out = _tel_class(tel, kind, args, out, res)
    return _dyn_of(state), out, tel


# -- group packing ---------------------------------------------------------

def _pad_rows(n: int) -> int:
    # coarse ladder (1, 8, 64, 512, ...): few distinct (R, K) shapes
    p = 1
    while p < n:
        p <<= 3
    return p


def _pad_slots(n: int) -> int:
    # finer ladder (1, 4, 16, ..., 1024): K is the expensive dimension
    p = 1
    while p < n:
        p <<= 2
    return p


def _build_group(batches, group, E: int, keyid_map, device=None):
    """The padded (row_idx int32 [R], sizes float32 [R, K], valid bool
    [R, K], key_ids int64 [R, 2]) group of one class on `device` (None =
    the CUDA card): `_group_arrays` staged onto the device."""
    dev = resolve_device(device)
    return tuple(_stage_in(a, dev)
                 for a in _group_arrays(batches, group, E, keyid_map))


def _group_arrays(batches, group, E: int, keyid_map):
    """The padded group of one class as host arrays. `batches[i]` holds
    the row at [1] and the frame lengths at [2] (the data plane's (wire,
    row, lens, frames, decided) tuples); `group` lists the batch indices
    of the class. Padding rows carry index E; key_ids holds each row's
    64-bit key id from `keyid_map` as its two uint32 words (0 on padding
    rows)."""
    R = len(group)
    K = max(len(batches[i][2]) for i in group)
    Rp, Kp = _pad_rows(R), _pad_slots(K)
    row_idx = np.full(Rp, E, np.int32)
    sizes = np.zeros((Rp, Kp), np.float32)
    valid = np.zeros((Rp, Kp), bool)
    key_ids = np.zeros((Rp, 2), np.int64)
    for r, i in enumerate(group):
        row, lens = batches[i][1], batches[i][2]
        m = len(lens)
        row_idx[r] = row
        sizes[r, :m] = lens
        valid[r, :m] = True
        kid = keyid_map.get(row, 0)
        key_ids[r, 0] = kid & 0xFFFFFFFF
        key_ids[r, 1] = kid >> 32
    return row_idx, sizes, valid, key_ids


# -- the sharded tick --------------------------------------------------------

def make_sharded_fused(mesh):
    """`fused_tick` over an edge-sharded state on `mesh` (a tuple of
    torch.devices, parallel/mesh.py). Returns

        fused(shards, dyn, key, elapsed_us, seq_args, tbf_args, ind_args,
              tel=None, *, uniforms=None) -> (key', sub, dyn', outs, tel')

    with `shards` the per-shard EdgeStates (mesh.shard_edge_state), `dyn`
    and `tel` per-shard lists (or None), the class args and uniforms
    replicated. `outs` is replicated (shard 0's copy is returned); dyn'
    and tel' are per-shard lists. Bit for bit `fused_tick` on the
    unsharded state. The shards run as a Python loop; each shard's work
    goes to its own device's current stream."""
    from kubedtn_tpu_torch.parallel import exchange as pex

    mesh = tuple(mesh)
    S = len(mesh)
    exch = pex.make_ring_exchange(S)

    def class_sharded(kind, args, u, sub, works, E):
        """One class on every shard: mailbox-pack each shard's owned
        rows, ring-exchange, run the row core on the assembled batch on
        every shard, scatter each shard's owned rows back into its block
        (`works[s]`, a dict of its columns, updated in place). Returns
        the per-shard (out, res, args)."""
        E_loc = E // S
        fmails, imails, local = [], [], []
        for s, (dev, w) in enumerate(zip(mesh, works)):
            a = tuple(x.to(dev) for x in args)
            rows = a[0].long()
            # padding rows carry index E: clamp for the gather (as the
            # unsharded gather clamps to row E-1), keep the raw index to
            # drop them from the scatter
            rows_c = rows.clamp_max(E - 1)
            off = s * E_loc
            owned = (rows_c >= off) & (rows_c < off + E_loc)
            li = torch.where(owned, rows_c - off, 0)

            def g(f):
                return w[f].index_select(0, li)

            fmail = torch.cat([g("props"), g("tokens")[:, None],
                               g("t_last")[:, None],
                               g("backlog_until")[:, None], g("corr")],
                              dim=1)
            imail = torch.stack([owned.to(torch.int32), g("pkt_count"),
                                 g("active").to(torch.int32)], dim=1)
            fmails.append(torch.where(owned[:, None], fmail, 0.0))
            imails.append(torch.where(owned[:, None], imail, 0))
            local.append((a, torch.where(owned & (rows < E), li, E_loc)))
        fg, ig = exch(fmails, imails)
        per_shard = []
        for s, (dev, w) in enumerate(zip(mesh, works)):
            a, tgt = local[s]
            f, i = fg[s], ig[s]
            cols = (f[:, :NPROP], i[:, 2] != 0, f[:, NPROP], f[:, NPROP + 1],
                    f[:, NPROP + 2], f[:, NPROP + 3:NPROP + 3 + NCORR],
                    i[:, 1])
            new, out, res = _class_rows(
                kind, cols, a[1], a[2], sub, a[3],
                None if u is None else u.to(dev))
            for fld, v in new.items():
                w[fld] = netem.scatter_rows(w[fld], tgt, v)
            per_shard.append((out, res, a))
        return per_shard

    def tel_local(tel_l, kind, args, out, res, s, E):
        """`_tel_class` on shard s: the [R, KCOLS] contribution computed
        replicated, only the shard's owned rows added."""
        rows, sizes, valid = args[0].long(), args[1], args[2]
        if kind == "tbf":
            rows = torch.where(out[5], E, rows)
        mat = tele.tel_matrix(sizes, valid, res, row_counts=out[2:5])
        E_loc = tel_l.shape[0]
        off = s * E_loc
        owned = (rows >= off) & (rows < off + E_loc)
        tgt = torch.where(owned, rows - off, E_loc)
        return netem.scatter_rows(tel_l, tgt, mat, add=True)

    def fused(shards, dyn, key, elapsed_us, seq_args, tbf_args, ind_args,
              tel=None, *, uniforms=None):
        if len(shards) != S:
            raise ValueError(f"{len(shards)} shards for a mesh of {S}")
        for st, dev in zip(shards, mesh):
            if st.device != dev:
                raise ValueError(f"a shard lies on {st.device}, its mesh "
                                 f"device is {dev}")
        if dyn is not None:
            shards = [_with_dyn(st, d) for st, d in zip(shards, dyn)]
        E = shards[0].capacity * S
        key, sub = split(key)
        works = [{f: getattr(_roll_clocks(st, elapsed_us), f)
                  for f in ROW_FIELDS} for st in shards]
        tels = None if tel is None else list(tel)
        outs = {}
        for kind, args in _class_args(seq_args, tbf_args, ind_args):
            u = uniforms.get(kind) if uniforms else None
            per_shard = class_sharded(kind, args, u, sub, works, E)
            if tels is not None:
                for s, (out, res, a) in enumerate(per_shard):
                    tels[s] = tel_local(tels[s], kind, a, out, res, s, E)
            outs[kind] = per_shard[0][0]
        dyn_out = [tuple(w[f] for f in DYN_FIELDS) for w in works]
        return key, sub, dyn_out, outs, tels

    return fused


def exchange_probe(mesh):
    """The mailbox exchange of `mesh` on its own, on replicated
    mailboxes: probe(fmail, imail) -> (fmail', imail') (shard 0's copy),
    the counterpart of the JAX plane's standalone exchange probe."""
    from kubedtn_tpu_torch.parallel import exchange as pex

    mesh = tuple(mesh)
    exch = pex.make_ring_exchange(len(mesh))

    def probe(fmail, imail):
        fg, ig = exch([fmail.to(d) for d in mesh],
                      [imail.to(d) for d in mesh])
        return fg[0], ig[0]

    return probe


# =========================================================================
# The host live plane: WireDataPlane
# =========================================================================

_ETH_IPV4 = 0x0800
_PROTO_TCP = 6

# wheel-token layout: (batch_seq << _TOK_BITS) | slot_index. Slots per
# batch are bounded by max_slots (default 4096) << 2^20; batch_seq wraps
# after 2^44 batches — beyond any process lifetime at data-plane rates.
_TOK_BITS = 20
_TOK_MASK = (1 << _TOK_BITS) - 1


class _LazyFrames:
    """Deferred materialization of a shaped batch's frames: the pending
    delay-line entry holds the drained parts (FrameSeg windows / bytes)
    and only turns them into per-frame bytes objects when delivery or a
    partial release actually needs them — the all-delivered whole-batch
    release (every latency-only batch) goes straight from the blob to the
    egress extend."""

    __slots__ = ("parts",)

    def __init__(self, parts) -> None:
        self.parts = parts

    def materialize(self) -> list[bytes]:
        from kubedtn_tpu_torch.wire.server import flatten_frames

        return flatten_frames(self.parts)


def _cat_lens(a, b):
    """Concatenate two per-frame length containers (int lists from the
    per-frame path, uint64 arrays from the segment path)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.concatenate([np.asarray(a, np.uint64),
                               np.asarray(b, np.uint64)])
    return a + b


def _split_parts(parts: list, k: int) -> tuple[list, list]:
    """Split a mixed parts list at frame index k (segments split by
    window index, zero copies)."""
    from kubedtn_tpu_torch.wire.server import FrameSeg

    head: list = []
    tail: list = []
    cnt = 0
    for p in parts:
        n = len(p) if type(p) is FrameSeg else 1
        if cnt >= k:
            tail.append(p)
        elif cnt + n <= k:
            head.append(p)
            cnt += n
        else:
            cut = k - cnt
            head.append(FrameSeg(p.blob, p.offs, p.lens, p.lo,
                                 p.lo + cut))
            tail.append(FrameSeg(p.blob, p.offs, p.lens, p.lo + cut,
                                 p.hi))
            cnt = k
    return head, tail


def parse_tcp_flow(frame: bytes) -> tuple[int, int, int, int] | None:
    """(src_ip, src_port, dst_ip, dst_port) for an IPv4/TCP ethernet
    frame, else None — the 4-tuple the bypass flow table keys on (the
    sockops programs see the same tuple, reference bpf/lib/sockops.c)."""
    if len(frame) < 14:
        return None
    off = 14
    ethertype = (frame[12] << 8) | frame[13]
    if ethertype == 0x8100 and len(frame) >= 18:  # 802.1Q
        ethertype = (frame[16] << 8) | frame[17]
        off = 18
    if ethertype != _ETH_IPV4 or len(frame) < off + 20:
        return None
    ihl = (frame[off] & 0x0F) * 4
    if frame[off] >> 4 != 4 or ihl < 20 or len(frame) < off + ihl + 4:
        return None
    if frame[off + 9] != _PROTO_TCP:
        return None
    # any fragment (MF set or non-zero offset) is out: non-first fragments
    # carry payload where the TCP header would be, and a fragmented flow
    # can't be consistently redirected anyway
    frag = ((frame[off + 6] << 8) | frame[off + 7]) & 0x3FFF
    if frag != 0:
        return None
    sip, dip = struct.unpack_from(">II", frame, off + 12)
    sport, dport = struct.unpack_from(">HH", frame, off + ihl)
    return sip, sport, dip, dport


class _RemoteStage:
    """Staging queue for released cross-node frames: the native SPSC
    FrameRing (bounded, overflow-counted). Packed entry: u16 addr_len |
    addr | u32 peer_intf_id | u64 trace_id | frame bytes (trace_id 0 =
    untraced; sampled frames carry their flight-recorder id across to
    the peer hop). Unlike the JAX package there is no deque fallback:
    the port's live plane needs the native library (its timing wheel
    and flow table are built from it first), so NativeUnavailable
    propagates."""

    def __init__(self, capacity_bytes: int = 4 << 20) -> None:
        from kubedtn_tpu_torch import native

        self._ring = native.FrameRing(capacity_bytes)

    def push(self, addr: str, intf_id: int, frame: bytes,
             trace_id: int = 0) -> bool:
        a = addr.encode()
        blob = struct.pack(">H", len(a)) + a \
            + struct.pack(">IQ", intf_id, trace_id) + frame
        return bool(self._ring.push(blob))

    def pop(self) -> tuple[str, int, int, bytes] | None:
        blob = self._ring.pop()
        if blob is None:
            return None
        alen = struct.unpack_from(">H", blob)[0]
        addr = blob[2:2 + alen].decode()
        intf, tid = struct.unpack_from(">IQ", blob, 2 + alen)
        return addr, intf, tid, blob[14 + alen:]

    @property
    def dropped(self) -> int:
        return self._ring.dropped


@guarded_by("_lock", "_batches", "_queued", "_pending", "dropped",
            "_traced", "_pos_enq", "_pos_done")
class _PeerSender:
    """One bounded queue + sender thread per peer daemon.

    The reference runs one goroutine per grpc-wire so a slow peer only
    stalls its own wires (grpcwire.go:386-462); here the unit is the
    peer daemon (frames to one peer share a channel and a coalesced
    SendToBulk stream anyway). The tick thread enqueues and returns;
    this thread does the blocking RPCs.

    Fault domain: a transient `grpc.RpcError` REQUEUES the
    batch and retries with exponential backoff + jitter instead of
    dropping it, behind a per-peer circuit breaker (closed → open after
    consecutive failures → one half-open probe → closed). While the
    breaker is open the queue doubles as a bounded OUTAGE BUFFER, so a
    short peer flap loses zero frames; overflow beyond MAX_QUEUED frames
    (queued + retry-pending) is dropped and counted (`dropped`) — the
    same bounded-memory backpressure as the staging ring. Fatal codes
    (schema/auth errors retrying cannot fix) drop the batch into
    daemon.forward_errors as before. Transport: coalesced SendToBulk,
    falling back to per-frame SendToStream for a peer that answers
    UNIMPLEMENTED — re-probed (not latched forever) at every breaker
    half-open probe, so an upgraded peer regains the bulk path. Breaker
    state and retry counters read through WireDataPlane.peer_fault_stats
    (the JAX package's metrics exporter is not ported yet)."""

    MAX_QUEUED = 262_144  # frames buffered per slow peer (~52MB at 200B)
    # grpc codes no retry can fix: the batch is counted and dropped
    _FATAL_CODES = frozenset({"INVALID_ARGUMENT", "NOT_FOUND",
                              "PERMISSION_DENIED", "UNAUTHENTICATED",
                              "UNIMPLEMENTED"})
    # frames per RPC attempt: after an outage the buffer can hold 100k+
    # frames, and one giant send can outlive ANY fixed deadline while a
    # live peer is still ingesting the stream — the retry then
    # re-delivers everything the peer already consumed. Bounded slices
    # advance through the buffer as each is acknowledged, so the
    # at-least-once ambiguity of a mid-stream deadline is capped at one
    # slice instead of the whole outage buffer.
    SEND_SLICE = 8_192
    # per-coalesced-chunk deadline allowance on top of the daemon's
    # forward_timeout_s floor: a healthy-but-slow peer gets time
    # proportional to the attempt's size instead of a spurious
    # DEADLINE_EXCEEDED (the duplicate-cascade trigger)
    PER_CHUNK_TIMEOUT_S = 0.02
    # give-up bound per head slice: a slice that fails DETERMINISTICALLY
    # with a nominally-transient code (RESOURCE_EXHAUSTED from an
    # oversized message, INTERNAL from a peer handler bug) must not pin
    # the buffer and wedge the peer's egress forever. Breaker cooldowns
    # gate the attempt rate, so a genuinely dead peer takes ~10+ minutes
    # of outage to exhaust this — flaps never come close.
    MAX_SLICE_RETRIES = 64
    # re-test a stream-only (UNIMPLEMENTED) latch this often even with
    # no outage: a peer upgraded during a quiet window must regain the
    # bulk path without waiting for a breaker cycle; a failed re-probe
    # costs one immediate UNIMPLEMENTED answer per interval
    BULK_REPROBE_S = 30.0

    def __init__(self, daemon, addr: str,
                 breaker: fault.CircuitBreaker | None = None,
                 backoff: fault.Backoff | None = None) -> None:
        self.daemon = daemon
        self.addr = addr
        self._batches: deque[list] = deque()
        self._queued = 0       # frames waiting in _batches
        self._pending = 0      # frames drained into the retry buffer
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._empty = threading.Event()
        self._empty.set()
        self._stopping = False
        self._interrupt = threading.Event()  # cuts backoff/breaker waits
        self.dropped = 0
        self.retries = 0     # transient-failure retry attempts
        self.sent = 0        # frames delivered to the peer
        self._bulk_reprobe_at = 0.0  # next idle re-test of the latch
        # flight-recorder bookkeeping: sampled frames in this sender's
        # buffer as [global_frame_pos, trace_id, outage_marked]. The
        # buffer drains strictly FIFO (batches → pending → sent
        # slices), so a monotonically increasing enqueue position plus
        # a resolved-frames counter locate every traced frame without
        # ever scanning a slice — O(sampled), not O(frames). Empty
        # whenever no recorder is attached.
        self._traced: deque = deque()
        self._pos_enq = 0    # frames ever accepted into the buffer
        self._pos_done = 0   # frames resolved (sent or given up)
        self.breaker = (breaker if breaker is not None
                        else fault.CircuitBreaker())
        self._backoff = (backoff if backoff is not None
                         else fault.Backoff())
        self._warn = fault.RateLimitedLog(min_interval_s=1.0)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"wire-egress-{addr}")
        self._thread.start()

    @property
    def buffered(self) -> int:
        """Frames currently held (queued + awaiting retry) — the outage
        buffer's fill level."""
        with self._lock:  # the two counters move together under it; an
            # unlocked sum can tear across a drain and go negative
            return self._queued + self._pending

    def _recorder(self):
        return getattr(self.daemon, "recorder", None)

    def enqueue(self, packets: list, traced: list | None = None) -> int:
        """Queue one tick's packets for this peer; never blocks.
        `traced` lists (index_in_packets, trace_id) for sampled frames.
        Returns how many were accepted (the rest are dropped and
        counted)."""
        rec = self._recorder()
        with self._lock:
            room = self.MAX_QUEUED - self._queued - self._pending
            if room <= 0:
                self.dropped += len(packets)
                take: list = []
            else:
                take = (packets if len(packets) <= room
                        else packets[:room])
                self.dropped += len(packets) - len(take)
                self._batches.append(take)
                self._queued += len(take)
                self._empty.clear()
            if rec is not None and traced:
                for idx, tid in traced:
                    if idx < len(take):
                        self._traced.append(
                            [self._pos_enq + idx, tid, False])
                    else:
                        rec.record(tid, tele.ST_EGRESS_DROP,
                                   reason="peer-queue-full",
                                   peer=self.addr)
            self._pos_enq += len(take)
        if take:
            self._wake.set()
        return len(take)

    def _traced_in_flight(self, upto: int):
        """Traced entries among the next `upto` unresolved frames."""
        with self._lock:  # _pos_done moves with _traced; reading it
            # outside can pair a stale base with a newer deque
            limit = self._pos_done + upto
            return [e for e in self._traced if e[0] < limit]

    def _advance_traced(self, n: int, stage: str, **detail) -> None:
        """Resolve the next `n` buffer frames (sent or given up):
        traced entries inside them get their terminal `stage` event."""
        rec = self._recorder()
        with self._lock:
            self._pos_done += n
            while self._traced and self._traced[0][0] < self._pos_done:
                e = self._traced.popleft()
                if rec is not None:
                    rec.record(e[1], stage, peer=self.addr, **detail)

    def _resolve_all_traced(self, stage: str, **detail) -> None:
        rec = self._recorder()
        with self._lock:
            self._pos_done = self._pos_enq
            while self._traced:
                e = self._traced.popleft()
                if rec is not None:
                    rec.record(e[1], stage, peer=self.addr, **detail)

    def _mark_outage(self) -> None:
        """First breaker-open park with frames buffered: every traced
        frame in the outage buffer records `outage-buffered` once."""
        rec = self._recorder()
        if rec is None:
            return
        with self._lock:
            entries = [e for e in self._traced if not e[2]]
            for e in entries:
                e[2] = True
        for e in entries:
            rec.record(e[1], tele.ST_OUTAGE, peer=self.addr,
                       breaker=fault.STATE_NAMES[self.breaker.state])

    def wait_empty(self, timeout_s: float) -> bool:
        return self._empty.wait(timeout_s)

    def request_stop(self) -> None:
        self._stopping = True
        self._wake.set()
        self._interrupt.set()

    def join(self, deadline: float) -> None:
        # keep re-arming the wake until the thread exits: a single set()
        # can be consumed by a drain already in flight, leaving the
        # thread parked on a cleared event with _stopping unobserved
        while self._thread.is_alive():
            self._wake.set()
            self._thread.join(0.05)
            if time.monotonic() >= deadline:
                break

    def stop(self, timeout_s: float = 5.0) -> None:
        self.request_stop()
        self.join(time.monotonic() + timeout_s)

    def _drop_pending(self, packets: list, to_errors: bool,
                      remaining: int = 0) -> None:
        """Give up on (part of) the retry buffer: count the loss
        (forward_errors for fatal codes, `dropped` for a shutdown with
        the peer still down), record the `remaining` retry-buffer
        frames the caller keeps, and release wait_empty callers only
        when truly nothing is left."""
        if to_errors:
            self.daemon.count_forward_errors(len(packets))
        with self._lock:
            # `dropped` shares the lock with enqueue()'s increments —
            # an unlocked read-modify-write here would lose counts
            if not to_errors:
                self.dropped += len(packets)
            self._pending = remaining
            if self._stopping:
                # frames still queued behind the give-up are lost with
                # the thread: counted, never silent
                while self._batches:
                    self.dropped += len(self._batches.popleft())
                self._queued = 0
            if not remaining and not self._batches:
                self._empty.set()

    def _run(self) -> None:
        import grpc

        from kubedtn_tpu_torch.utils.logging import fields, get_logger
        from kubedtn_tpu_torch.wire import proto as pb

        log = get_logger("wire-egress")
        daemon = self.daemon
        addr = self.addr
        chunk = WireDataPlane.BULK_CHUNK
        pending: list = []  # retry buffer: drained but not yet delivered
        slice_attempts = 0  # failures of the CURRENT head slice
        while True:
            if not pending:
                self._wake.wait()
                # drain the whole backlog into one send: frames queued
                # while the peer was slow coalesce into fewer messages
                with self._lock:
                    self._wake.clear()
                    while self._batches:
                        pending.extend(self._batches.popleft())
                    self._queued = 0
                    self._pending = len(pending)
                    if not pending:
                        self._empty.set()
                if not pending:
                    if self._stopping:
                        return
                    continue
            if not self.breaker.allow():
                if self._stopping:
                    # orderly shutdown must not hang on a dead peer's
                    # cooldown: the buffered frames are lost and counted
                    self._drop_pending(pending, to_errors=False)
                    self._resolve_all_traced(tele.ST_EGRESS_DROP,
                                             reason="shutdown")
                    return
                # breaker OPEN: park until the half-open probe is due
                # (or a stop request), without dropping anything — the
                # queue is the bounded outage buffer. Sampled frames in
                # the buffer record `outage-buffered` (once each).
                self._mark_outage()
                self._interrupt.wait(
                    min(max(self.breaker.time_to_probe(), 0.005), 0.25))
                self._interrupt.clear()
                continue
            if self.breaker.state == fault.HALF_OPEN:
                # recovery probe: a restarted/upgraded peer may speak
                # the coalesced bulk transport again — the stream-only
                # latch is re-tested here, never held forever
                daemon.reset_peer_bulk(addr)
            elif (not daemon.peer_bulk_ok.get(addr, True)
                    and time.monotonic() >= self._bulk_reprobe_at):
                # periodic re-test with NO outage: an upgrade during a
                # quiet window must not leave the peer latched to the
                # per-frame stream until the next breaker cycle
                daemon.reset_peer_bulk(addr)
            sl = pending[:self.SEND_SLICE]
            n_chunks = -(-len(sl) // chunk)
            timeout = (daemon.forward_timeout_s
                       + self.PER_CHUNK_TIMEOUT_S * n_chunks)
            try:
                sent = False
                if daemon.peer_bulk_ok.get(addr, True):
                    chunks = [
                        pb.PacketBatch(packets=sl[i:i + chunk])
                        for i in range(0, len(sl), chunk)]
                    try:
                        daemon._peer_wire_client(addr).SendToBulk(
                            iter(chunks), timeout=timeout)
                        sent = True
                    except grpc.RpcError as e:
                        if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                            raise
                        # reference-built peer: per-frame stream until
                        # the next breaker probe (or periodic idle
                        # re-probe) re-tests the bulk path
                        daemon.peer_bulk_ok[addr] = False
                        self._bulk_reprobe_at = (time.monotonic()
                                                 + self.BULK_REPROBE_S)
                if not sent:
                    daemon._peer_wire_client(addr).SendToStream(
                        iter(sl), timeout=timeout)
            except Exception as e:
                code = None
                if isinstance(e, grpc.RpcError):
                    try:
                        code = e.code()
                    except Exception:
                        code = None
                fatal = (not isinstance(e, grpc.RpcError)
                         or (code is not None
                             and code.name in self._FATAL_CODES))
                self.breaker.record_failure()
                fire, suppressed = self._warn.ready()
                if fire:
                    # the failing peer and its grpc status, rate-limited
                    # — a flapping peer at tick cadence must not emit
                    # hundreds of lines/s, but must never fail silently
                    log.warning("peer send failed %s", fields(
                        peer=addr,
                        code=(code.name if code is not None
                              else type(e).__name__),
                        frames=len(sl), fatal=fatal,
                        breaker=fault.STATE_NAMES[self.breaker.state],
                        retries=self.retries, suppressed=suppressed))
                slice_attempts += 1
                if fatal or slice_attempts >= self.MAX_SLICE_RETRIES:
                    # only the failing slice is dropped (fatal code, or
                    # a deterministic failure that exhausted its retry
                    # budget); the rest of the buffer still gets its
                    # own attempts
                    pending = pending[len(sl):]
                    self._drop_pending(sl, to_errors=True,
                                       remaining=len(pending))
                    self._advance_traced(
                        len(sl), tele.ST_EGRESS_DROP,
                        reason=(code.name if code is not None
                                else "fatal"))
                    slice_attempts = 0
                    self._backoff.reset()
                    continue
                if self._stopping:
                    self._drop_pending(pending, to_errors=False)
                    self._resolve_all_traced(tele.ST_EGRESS_DROP,
                                             reason="shutdown")
                    return
                # transient: keep the slice, back off, try again — the
                # slice's sampled frames record each retry attempt
                rec = self._recorder()
                if rec is not None:
                    for e in self._traced_in_flight(len(sl)):
                        rec.record(e[1], tele.ST_RETRIED,
                                   peer=self.addr, attempt=slice_attempts)
                self.retries += 1
                self._interrupt.wait(self._backoff.next_delay())
                self._interrupt.clear()
                continue
            # slice delivered: advance through the buffer
            self.breaker.record_success()
            slice_attempts = 0
            self._backoff.reset()
            self.sent += len(sl)
            pending = pending[len(sl):]
            self._advance_traced(len(sl), tele.ST_SENT)
            with self._lock:
                self._pending = len(pending)
                # "empty" means queue drained AND nothing in flight —
                # wait_empty callers (tests, shutdown) need the RPC done
                if not pending and not self._batches:
                    self._empty.set()


class _GCTuner:
    """gc.freeze() + relaxed gen-2 threshold while ANY data-plane runner
    is live: the soaks measured 0.06-0.22s gen-2 pauses
    (live_soak.gc_pause_s) from full collections walking the long-lived
    engine/topology object graph on every threshold trip.
    Freezing moves the steady-state graph into the permanent generation
    (never scanned again) and the raised gen-2 threshold makes the
    remaining full collections rare; per-tick garbage still dies young
    in gen 0/1. Refcounted: processes running several planes (tests,
    multi-daemon scenarios) restore the interpreter defaults only when
    the LAST runner stops.

    Pause attribution: while any runner is live a gc.callbacks hook
    times each collection and reports it (cause "gc", with the
    generation and collected-object count) to every registered
    PauseLedger — the ledgers the live planes own, held weakly so a
    stopped plane never leaks through the class-level registry."""

    _lock = threading.Lock()
    _count = 0
    _saved: tuple | None = None
    _ledgers: "weakref.WeakSet" = None  # built on first acquire
    _gc_t0: float | None = None

    @classmethod
    def register_ledger(cls, ledger) -> None:
        import weakref

        with cls._lock:
            if cls._ledgers is None:
                cls._ledgers = weakref.WeakSet()
            cls._ledgers.add(ledger)

    @classmethod
    def _on_gc(cls, phase: str, info: dict) -> None:
        # gc callbacks run on whichever thread tripped the threshold —
        # record() is thread-safe and lock-cheap, so this stays on the
        # collection path without measurable cost (collections are rare
        # by construction while the tuner holds the relaxed thresholds)
        if phase == "start":
            cls._gc_t0 = time.perf_counter()
            return
        t0 = cls._gc_t0
        if t0 is None:
            return
        cls._gc_t0 = None
        dur = time.perf_counter() - t0
        ledgers = cls._ledgers
        if not ledgers:
            return
        for led in list(ledgers):
            led.record("gc", dur,
                       generation=info.get("generation", -1),
                       collected=info.get("collected", 0))

    @classmethod
    def acquire(cls) -> None:
        with cls._lock:
            cls._count += 1
            if cls._count > 1:
                return
            cls._saved = gc.get_threshold()
            gc.collect()
            gc.freeze()
            t0, t1, _t2 = cls._saved
            gc.set_threshold(t0, t1, max(_t2 * 10, 100))
            if cls._on_gc not in gc.callbacks:
                gc.callbacks.append(cls._on_gc)

    @classmethod
    def refreeze(cls) -> None:
        """Freeze objects allocated since acquire() (state built by
        plane warm-up) — freezing is additive; callers invoke this after
        their warm phase so steady state scans nothing old."""
        with cls._lock:
            if cls._count:
                gc.collect()
                gc.freeze()

    @classmethod
    def release(cls) -> None:
        with cls._lock:
            if cls._count == 0:
                return
            cls._count -= 1
            if cls._count:
                return
            if cls._saved is not None:
                gc.set_threshold(*cls._saved)
                cls._saved = None
            gc.unfreeze()
            try:
                gc.callbacks.remove(cls._on_gc)
            except ValueError:
                pass


class _CPUThreadCap:
    """One torch intra-op thread while ANY runner of a CPU plane is
    live. A CPU plane's tick is many small ops; the default intra-op
    pool (a thread per core, and one OpenMP team per calling thread)
    buys nothing on them, and where several such processes share a host
    a parallel op waits for threads that the others hold: the runner
    then misses whole seconds (a live_plane_soak window of 0 frames
    beside five other busy pytest workers on 8 cores). The cap is set
    before the runner thread starts, so the runner and the threads it
    starts take it; refcounted like _GCTuner, the count in force before
    the first acquire comes back when the LAST one releases. CUDA
    planes never take it."""

    _lock = threading.Lock()
    _count = 0
    _saved = 0

    @classmethod
    def acquire(cls) -> None:
        with cls._lock:
            cls._count += 1
            if cls._count == 1:
                cls._saved = torch.get_num_threads()
                torch.set_num_threads(1)

    @classmethod
    def release(cls) -> None:
        with cls._lock:
            if cls._count == 0:
                return
            cls._count -= 1
            if cls._count == 0:
                torch.set_num_threads(cls._saved)


def _stage_in(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`. On the card it goes through a pinned
    staging buffer and a non-blocking copy, so the host never waits for
    the kernels already queued on the stream (a copy from pageable
    memory would, and the depth-2 pipeline would silently become depth
    1). Every host-to-device copy of the plane goes through here. PyTorch's pinned-memory cache hands the buffer out again only
    after the copy's stream has passed it. On the CPU the tensor shares
    the array's memory (the plane never writes the array again)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(dev, non_blocking=True)


class _HostOuts:
    """A job's device outputs on their way to the host: on the card, each
    output is copied into a pinned buffer with a non-blocking copy queued
    right behind the tick's kernels, and one CUDA event follows the
    copies. `wait()` is the pipeline's only sync point and returns the
    outputs as numpy arrays."""

    __slots__ = ("_host", "_event")

    def __init__(self, outs) -> None:
        dev = outs[0].device
        if dev.type != "cuda":
            self._host, self._event = list(outs), None
            return
        host = []
        for x in outs:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            host.append(h)
        self._host = host
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(dev))

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def _zero_counters(capacity: int) -> EdgeCounters:
    """Cumulative per-edge counters of the live plane, on the HOST:
    float32 numpy arrays (the plane adds to them at completion)."""
    return EdgeCounters(**{f.name: np.zeros(capacity, np.float32)
                           for f in dataclasses.fields(EdgeCounters)})


def _grown_counters(counters: EdgeCounters, capacity: int) -> EdgeCounters:
    """`counters` on an engine grown to `capacity` rows: each row keeps
    its counts, the new rows start at zero. The JAX plane replaces them
    with zeros, so every tenant's counted deliveries vanish when another
    tenant's rows grow the engine — a migration onto a plane that then
    grows under a later RESTORE loses its delivered counts from the
    accounting (tests/test_torch_federation.py pins both)."""
    def grow(a: np.ndarray) -> np.ndarray:
        out = np.zeros((capacity,) + a.shape[1:], a.dtype)
        n = min(capacity, a.shape[0])
        out[:n] = a[:n]
        return out

    return EdgeCounters(**{f.name: grow(getattr(counters, f.name))
                           for f in dataclasses.fields(EdgeCounters)})


class _ShapeJob:
    """One in-flight tick's shaping dispatch. The device outputs stay on
    their way to the host (`_HostOuts`) until _complete() — the dispatch
    path never blocks on the device. `groups` entries are (kind,
    batch-idx list, padded row_idx / sizes / valid / key_ids numpy
    arrays, _HostOuts); `touched_after` collects rows the control plane
    re-initialized after this dispatch (their write-back must not
    resurrect this job's pre-touch dynamics). `tbf_pre` holds the TBF
    group's rows as the dispatch shaped them from (props, active and the
    five dynamic columns, gathered on the device before the clock roll):
    the TBF fallback re-shape reads them at completion, when the
    engine's tensors may have been updated in place since. `dyn_after`
    the chained columns after this tick; `sub` the tick's sub-key."""

    __slots__ = ("now_s", "base_us", "shaped_at", "prev_shaped_s",
                 "batches", "rowinfo", "groups", "tbf_pre", "dyn_after",
                 "sub", "touched_after", "touched_all", "force_rows",
                 "samples", "has_tel", "capacity")

    def __init__(self, now_s, base_us, shaped_at, prev_shaped_s,
                 batches, rowinfo, capacity) -> None:
        self.now_s = now_s
        self.base_us = base_us
        self.shaped_at = shaped_at
        self.prev_shaped_s = prev_shaped_s
        self.batches = batches
        self.rowinfo = rowinfo
        self.capacity = capacity
        self.groups: list = []
        self.tbf_pre = None
        self.dyn_after = None
        self.sub = None
        self.touched_after: set[int] = set()
        # compact() renumbered every row after this dispatch: the whole
        # write-back is void (the "all rows touched" form, raised as a
        # flag so nobody materializes an O(capacity) row set)
        self.touched_all: bool = False
        # rows an OLDER job's TBF fallback corrected after this job
        # dispatched: this job's device results for them came from the
        # stale pre-correction chain, so _complete re-shapes them with
        # the exact scan from the corrected engine columns
        self.force_rows: set[int] = set()
        # flight-recorder samples per batch index: [(offset, trace_id)]
        self.samples: list | None = None
        self.has_tel = False


# Tick-state ownership: everything the dispatch/complete/release path
# mutates is owned by the re-entrant _tick_lock. Public counters
# (ticks/shaped/dropped/...) are deliberately NOT listed: they are
# single-writer (the tick thread) and metrics scrapes tolerate torn
# reads.
@guarded_by("_tick_lock", "_holdback", "_pending", "_bseq", "_inflight",
            "_pipe_state", "_key", "_need_resync", "_chain_shaped_s",
            "_last_shaped_s", "_origin_s", "_disp_items", "_disp_decided",
            "_disp_samples", "_disp_samp_adv", "_drain_budget",
            "_props_cache", "_update_stager")
class WireDataPlane:
    """Shapes wire frames through the engine's edge state in real time
    (module docstring)."""

    def __init__(self, daemon, dt_us: float = 10_000.0,
                 max_slots: int = 4096, seed: int = 0,
                 pipeline_depth: int | None = None) -> None:
        from kubedtn_tpu_torch import native
        from kubedtn_tpu_torch.pauses import PauseLedger

        self.daemon = daemon
        self.engine = daemon.engine
        self.device = self.engine.device
        self.dt_us = dt_us
        # per-wire drain budget per tick. Slot-independent rows and plain
        # rate-limited rows shape all of it in one dispatch; only
        # correlated/reordering rows are capped at seq_slots per tick
        # and keep the residue queued in order. The budget only BINDS
        # under saturation (light-load drains take whatever is queued).
        self.max_slots = max_slots
        self.seq_slots = 64
        # Frames drained but deferred by the seq_slots cap wait HERE, not
        # back on wire.ingress: re-queueing them would re-classify them
        # and re-run the bypass decision every tick (each frame must
        # count and decide exactly once). Holdback frames shape FIRST
        # next tick (FIFO), and their wires are excluded from the next
        # drain so the buffer stays bounded by max_slots per wire.
        self._holdback: dict[int, tuple[object, list[int],
                                        list[bytes]]] = {}
        self._key = tick_key(seed)
        # one tick at a time; the ENGINE lock is held only for snapshot
        # and write-back, never across device dispatch. Re-entrant: a
        # compact() triggered from code already inside a tick (its
        # counter-remap callback takes this lock) must not self-deadlock
        self._tick_lock = threading.RLock()
        # wheel time is µs since the first tick's clock (which may be the
        # wall clock or a synthetic test clock)
        self._origin_s: float | None = None
        # wall time of the last tick whose write-back LANDED: the elapsed
        # gap rolls the persistent netem/TBF clocks (t_last,
        # backlog_until) back before the next batch, so token buckets
        # refill with real time
        self._last_shaped_s: float | None = None
        # delay-line payload store, BATCH-granular: a wheel token
        # encodes (batch_seq << _TOK_BITS) | slot_index, and _pending
        # maps batch_seq → [pod_key, uid, frames, deadlines, remaining
        # (, slot → trace id)] — ONE dict insert per shaped batch
        self._pending: dict[int, list] = {}
        self._bseq = 0
        # the native timing wheel (required: no heap fallback) and the
        # TCP/IP bypass flow table (eBPF sockops/redir equivalent)
        self._wheel = native.TimingWheel(tick_us=1000)
        self._flowtable = native.FlowTable()
        # the CPython extension that materializes released segments in
        # one C loop: built here, so a build failure surfaces at
        # construction and not inside a tick (None where the Python
        # headers do not resolve: the pure-Python path then runs)
        native.kdt_ext()
        self._remote = _RemoteStage()
        # one sender thread + bounded queue per peer daemon: a slow peer
        # stalls only its own wires, never the tick
        self._peer_senders: dict[str, _PeerSender] = {}
        # released frames whose wire isn't registered YET: retried each
        # release until the grace expires
        self._orphans: deque[tuple[float, str, int, bytes]] = deque()
        self.orphan_grace_s = 30.0
        self.undeliverable = 0  # orphans whose wire never came back
        self._stop = threading.Event()
        # set by the daemon whenever ingress queues: the runner wakes and
        # ticks immediately instead of sleeping out the period
        self._wake = threading.Event()
        daemon.ingress_signal = self._wake
        daemon.dataplane = self
        self._thread: threading.Thread | None = None
        self.counters: EdgeCounters = _zero_counters(
            self.engine.state.capacity)
        # engine.compact() renumbers rows; the cumulative per-row
        # counters must follow them
        self.engine.on_rows_remapped(self._on_rows_remapped)
        self.ticks = 0
        self.shaped = 0
        self.dropped = 0
        self.bypassed = 0      # frames that skipped shaping entirely
        self.tick_errors = 0   # unexpected tick failures (thread survives)
        self.fallbacks = 0     # TBF rows re-shaped by the exact scan
        # cumulative wall seconds per tick stage: drain = ingress
        # collection, decide = classify + bypass verdict, kernel =
        # device DISPATCH (host side of the tick's device program), sync
        # = waiting on a job's device outputs, schedule = pending/wheel
        # inserts + counters, release = due-frame delivery
        self.stage_s = {"drain": 0.0, "decide": 0.0, "kernel": 0.0,
                        "sync": 0.0, "schedule": 0.0, "release": 0.0}
        # every tick-lock barrier site reports into the pause ledger;
        # tick() attributes each tick's wall latency to the dominant
        # cause. The engine carries a back-reference so compact()
        # reports into the same ledger.
        self.pauses = PauseLedger()
        self.engine.pauses = self.pauses
        _GCTuner.register_ledger(self.pauses)
        self.last_now_s: float | None = None  # clock of the latest tick
        self._clock_ext = False  # latest tick ran on a caller-supplied clock
        self._ff_active = False  # fast_forward loop in progress
        # -- pipelined tick engine -------------------------------------
        # depth-N in-flight ring: dispatch tick N's device shaping
        # without blocking, consume tick N-1's results while N computes.
        # Explicit-clock ticks stay synchronous (depth 1) unless
        # pipeline_explicit_clock opts in (determinism tests). The
        # default depth is 2 on the card (the host stages overlap the
        # device) and 1 on the CPU (there the "device" work runs on the
        # calling thread, so there is nothing to overlap).
        if pipeline_depth is None:
            pipeline_depth = 2 if self.device.type == "cuda" else 1
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.pipeline_explicit_clock = False
        self._inflight: deque[_ShapeJob] = deque()
        # chained dynamic edge-state columns (device tensors, possibly
        # still computing): the dispatch-time truth the next tick shapes
        # against while the engine's write-back trails by <= depth-1
        # ticks. None = engine state is current.
        self._pipe_state = None
        # wall clock of the newest DISPATCHED shaping — the chain's
        # epoch; _last_shaped_s tracks the newest WRITTEN-BACK one
        self._chain_shaped_s: float | None = None
        # a completed job's TBF-fallback re-shape corrected engine rows
        # that newer in-flight dispatches shaped against: drain the
        # pipeline before the next dispatch so it reads corrected state
        self._need_resync = False
        # host mirror of the props table: (engine.props_gen, numpy). The
        # engine's batch ops update props IN PLACE, so the mirror is
        # keyed on the engine's generation counter, never on tensor
        # identity (which an in-place UpdateLinks keeps)
        self._props_cache: tuple = (None, None)
        # the planned-update stager (update_stager), made on first use
        self._update_stager = None
        # adaptive drain budget (runner ticks only): halves toward
        # adapt_min_slots while the ingress backlog stays empty, doubles
        # back toward max_slots while the backlog grows across the
        # sliding window. Explicit-clock ticks always drain at max_slots.
        self.adapt_min_slots = min(512, max_slots)
        self._drain_budget = max_slots
        self._bl_win: deque[int] = deque(maxlen=4)
        self.last_backlog = 0  # drainable frames left after the last tick
        self._gc_held = False
        # optional chaos.ChaosInjector (tests / chip_smoke's flap run);
        # consulted at the head of every dispatch when set
        self.chaos = None
        # optional tenancy.TenantRegistry (attach_tenancy): per-tenant
        # admission and QoS drain weights at every tick's drain
        self.tenancy = None
        # dispatch-failure requeue bookkeeping: what the in-progress
        # dispatch holds and whether its frames passed the decide stage
        self._disp_items: list | None = None
        self._disp_decided = False
        self._disp_samples: list | None = None
        self._disp_samp_adv: list | None = None
        # graceful-degradation ladder: 0 = configured pipeline depth,
        # 1 = depth-1 (overlap off), 2 = synchronous un-fused per-class
        # dispatches. The runner's supervisor steps DOWN one level after
        # degrade_after consecutive tick failures and back UP after a
        # clean promote_after_s; every transition crosses the flush()
        # barrier so delivery order stays byte-identical.
        self.degrade_level = 0
        self.degrade_after = 3
        self.promote_after_s = 5.0
        self.degradations = 0
        self.promotions = 0
        self._consec_fail = 0
        self._last_fail_s: float | None = None
        self._last_transition_s: float | None = None
        # heartbeat watchdog over the runner thread: the runner stamps
        # _heartbeat_s every loop; a sidecar thread counts (and logs,
        # rate-limited) stalls beyond watchdog_timeout_s. It arms after
        # the runner's FIRST completed tick (that tick loads the kernel
        # libraries: warm-up, not a stall).
        self.watchdog_timeout_s = 5.0
        self.watchdog_stalls = 0
        self._heartbeat_s: float | None = None
        self._watchdog_thread: threading.Thread | None = None
        self._watchdog_stop = threading.Event()
        self._watchdog_armed = False
        # -- link telemetry plane --------------------------------------
        self.telemetry: tele.LinkTelemetry | None = None
        self.recorder: tele.FlightRecorder | None = None
        # -- sharded live plane ----------------------------------------
        # None until enable_sharding(): each dispatch then splits the
        # state into the mesh's shards and runs make_sharded_fused's
        # program (the ring exchange is kernel K4 on the card)
        self._shard_mesh = None
        self._sharded_fused = None
        self.shard_xfrm = 0            # cumulative cross-shard frames
        self.shard_xfrm_last = 0       # cross-shard frames, last tick
        self.shard_mailbox_hwm = 0     # mailbox rows high-water mark
        # the sampled exchange probe behind `exchange_seconds`: the ring
        # rides inside the sharded dispatch, so its cost is measured by
        # running it alone on a mailbox of the dispatch's padded rows,
        # on dispatches 1, 65, 129, ... (K4 on the card)
        self.shard_exchange_s = 0.0    # sampled exchange-probe seconds
        self.shard_exchange_runs = 0   # probe runs since enable_sharding
        self._exchange_probe = None
        self._exchange_count = 0       # dispatches since enable_sharding

    def enable_sharding(self, mesh=None, n_devices: int | None = None):
        """Run the plane's tick as the sharded program of
        `make_sharded_fused` over `mesh` (parallel/mesh.make_mesh: a
        tuple of devices, repeats make virtual shards). Without a mesh,
        `n_devices` shards (default: the largest power of two of the
        visible cards) over the cards, or virtual shards of the CPU when
        the plane runs there. The engine keeps its state whole; each
        dispatch splits it into the shards, and the tick's outputs come
        back joined, so the rest of the plane is unchanged. The mesh size
        must be a power of two (block sharding keeps dividing the
        engine's power-of-two growth); the capacity is grown to a
        multiple of it. Crosses the flush() barrier; delivery is bit for
        bit the unsharded plane's. Returns the mesh."""
        from kubedtn_tpu_torch.parallel import mesh as pmesh

        with self._tick_lock:
            self.flush()
            if mesh is None:
                if self.device.type == "cuda":
                    avail = torch.cuda.device_count()
                    n = n_devices or 1
                    if n_devices is None:
                        while n * 2 <= avail:
                            n *= 2
                    mesh = pmesh.make_mesh(
                        [torch.device("cuda", i % avail) for i in range(n)])
                else:
                    mesh = pmesh.make_mesh([self.device] * (n_devices or 1))
            mesh = pmesh.make_mesh(mesh)
            S = len(mesh)
            if S & (S - 1):
                raise ValueError(
                    f"mesh size must be a power of two (block sharding "
                    f"must keep dividing the engine's power-of-two "
                    f"capacity growth); got {S}")
            engine = self.engine
            with engine._lock:
                engine._flush_device_locked()
                st = engine._state
                if st.capacity % S:
                    engine.state = es.grow_state(
                        st, -(-st.capacity // S) * S)
                engine.shard_count = S
            self._shard_mesh = mesh
            self._sharded_fused = make_sharded_fused(mesh)
            self._exchange_probe = exchange_probe(mesh) if S > 1 else None
            self.shard_xfrm = 0
            self.shard_xfrm_last = 0
            self.shard_mailbox_hwm = 0
            self.shard_exchange_s = 0.0
            self.shard_exchange_runs = 0
            self._exchange_count = 0
        return mesh

    # dtnlint: sync-ok(the sampled exchange probe, one dispatch in 64 of a sharded plane: its waits bound the wall time of the ring it measures; ROADMAP lists it as perf work)
    def _run_exchange_probe(self, rows: int) -> None:
        """One run of the exchange probe on zero mailboxes of `rows`
        padded rows (a [rows, NPROP + 3 + NCORR] f32 payload and a
        [rows, 3] i32 one), its synchronised wall time added to
        shard_exchange_s."""
        fm = torch.zeros((rows, NPROP + 3 + NCORR), dtype=torch.float32,
                         device=self.device)
        im = torch.zeros((rows, 3), dtype=torch.int32, device=self.device)
        cards = [d for d in dict.fromkeys(self._shard_mesh)
                 if d.type == "cuda"]
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        self._exchange_probe(fm, im)
        for d in cards:
            torch.cuda.synchronize(d)
        self.shard_exchange_s += time.perf_counter() - t0
        self.shard_exchange_runs += 1

    def shard_summary(self) -> dict:
        """Sharding posture + partition quality + mailbox counters."""
        if self._shard_mesh is None:
            return {"enabled": False, "mesh_shape": [1], "n_shards": 1}
        from kubedtn_tpu_torch.parallel.partition import colocation_stats

        S = len(self._shard_mesh)
        try:
            out = colocation_stats(self.engine, S)
        except ValueError:
            out = {"n_shards": S}
        out.update({
            "enabled": True,
            "mesh_shape": [S],
            "devices": [str(d) for d in self._shard_mesh],
            "xshard_frames": int(self.shard_xfrm),
            "xshard_frames_last": int(self.shard_xfrm_last),
            "mailbox_hwm": int(self.shard_mailbox_hwm),
            "exchange_seconds": round(self.shard_exchange_s, 6),
        })
        return out

    def enable_telemetry(self, window_s: float = 1.0, windows: int = 12,
                         sample_period: int = 256,
                         recorder_capacity: int = 65_536,
                         node: str | None = None):
        """Switch the link telemetry plane on: the tick starts chaining
        the per-edge window accumulator and the deterministic
        hash-sampled flight recorder follows 1/`sample_period` of the
        frames through their lifecycle. The recorder is also installed
        on the daemon (ObserveTrace). Crosses the flush() barrier.
        Returns (LinkTelemetry, FlightRecorder)."""
        with self._tick_lock:
            self.flush()
            self.telemetry = tele.LinkTelemetry(
                self.engine.state.capacity, window_s=window_s,
                windows=windows, device=self.device)
            self.recorder = tele.FlightRecorder(
                node=node or getattr(self.engine, "node_ip", "")
                or "local",
                sample_period=sample_period,
                capacity=recorder_capacity)
            self.daemon.recorder = self.recorder
        return self.telemetry, self.recorder

    # -- bypass --------------------------------------------------------

    def _try_bypass(self, row: int, frame: bytes,
                    target: tuple[str, int] | None,
                    shaped_rows: set[int]) -> bool:
        """eBPF-bypass semantics per frame (the per-frame form of the
        batched decision in _dispatch_inner). Returns True when the
        frame short-circuited shaping and was delivered."""
        ft = self._flowtable
        if target is None:
            return False
        # sockops redirection is strictly SAME-NODE (socket-to-socket,
        # redir.c:24-42): the peer end must be a local wire
        peer_wire = self.daemon.wires.get_by_key(*target)
        if peer_wire is None or peer_wire.peer_ip:
            return False
        tup = parse_tcp_flow(frame)
        if tup is None:
            return False  # sockops only ever accelerates TCP
        sip, sport, dip, dport = tup
        if ft.flag(sip, sport, dip, dport) is None:
            # first sight of the flow: both endpoints are local wires, so
            # both sockops hooks fire here (active then passive establish)
            ft.active_established(sip, sport, dip, dport)
            ft.passive_established(dip, dport, sip, sport)
        if row in shaped_rows:
            # traffic crossing a shaped device disables the flow FOREVER,
            # even if the device is later unshaped (redir_disable.c:44-48)
            ft.shaped_egress(sip, sport, dip, dport)
            return False
        if ft.msg_redirect(sip, sport, dip, dport):
            self.bypassed += 1
            self.daemon.deliver_egress(*target, frame)  # latency ≈ 0
            return True
        return False

    @property
    def ring_dropped(self) -> int:
        """Frames lost to remote-stage ring overflow (bounded-memory
        backpressure, like pcap buffer drops in the reference)."""
        return self._remote.dropped

    @property
    def flow_stats(self) -> dict:
        """The TCP/IP bypass flow table's counts, under the JAX plane's
        keys; "available" is always true, since the port requires the
        native table."""
        ft = self._flowtable
        return {"available": True, "flows": len(ft),
                "bypassed": ft.bypassed, "passed": ft.passed}

    @property
    def running(self) -> bool:
        """True while the real-time runner thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    # -- one step ------------------------------------------------------

    def tick(self, now_s: float | None = None) -> int:
        """Drain ingress, dispatch shaping, consume completed pipeline
        jobs, release due frames. Returns the number of frames whose
        shaping COMPLETED this tick (with the pipeline at depth 1 — any
        explicit-clock tick by default — that is exactly the frames
        shaped this tick)."""
        # timed AROUND the lock acquisition: a tick that waited behind a
        # barrier holder attributes that wait to the barrier's cause
        t0 = time.perf_counter()
        with self._tick_lock:
            shaped = self._tick_inner(now_s)
        self.pauses.note_tick(time.perf_counter() - t0)
        return shaped

    @requires_lock("_tick_lock")
    def _complete_or_requeue(self, job: _ShapeJob) -> int:
        """_complete with the zero-frame-loss guarantee: a completion
        failure (a device error surfacing at the sync point) requeues
        the job's drained frames into the holdback buffer before
        propagating."""
        try:
            return self._complete(job)
        except Exception:
            rec = self.recorder
            if rec is not None and job.samples:
                for sm in job.samples:
                    for _off, tid in sm:
                        rec.record(tid, tele.ST_REQUEUED,
                                   reason="completion-fault")
            self._requeue_failed(job.batches, True)
            raise

    def flush(self) -> int:
        """Pipeline barrier: complete every in-flight shaping dispatch
        and return the frames shaped. Everything that reads or rewrites
        the shared delay-line / engine state (fast_forward's epilogue,
        compact()'s counter remap, start()'s clock rebase, stop(), the
        sharding / telemetry / ladder switches) crosses this barrier
        first, so stage overlap never leaks a half-applied tick."""
        with self._tick_lock:
            if not self._inflight:
                self._pipe_state = None
                self._need_resync = False
                return 0
            shaped = 0
            t0 = time.perf_counter()
            while self._inflight:
                shaped += self._complete_or_requeue(
                    self._inflight.popleft())
            self._pipe_state = None
            self._need_resync = False
            self.pauses.record("pipeline_flush",
                               time.perf_counter() - t0, rows=shaped)
            return shaped

    def stage_update_round(self, apply_fn, cause: str = "staged_update",
                           **detail):
        """Planned-update staging barrier (updates.stager): complete
        every in-flight dispatch, run `apply_fn` (one round's engine
        edits — it returns whatever the stager needs), and flush the
        engine's pending scatters before the lock drops, so the next
        tick snapshots the round fully applied or not at all. The
        runner pauses one barrier per round, never stops. Re-entrant
        under the tick lock (the stager's rollback holds it while
        replaying the journal).

        The engine flush runs in a FINALLY: if apply_fn raises after
        enqueueing part of the round, the registries have already
        moved, so the device must move with them before the lock can
        drop — otherwise the next tick's lazy engine.state flush would
        land the half-round mid-shaping. The stager's _apply_round
        additionally replays its journal inside the same lock hold, so
        no tick ever shapes against the mixture.

        `cause`/`detail` label the pause in the plane's ledger (the
        stager passes its plan id)."""
        with self._tick_lock:
            with self.pauses.pause(cause, **detail):
                self.flush()
                try:
                    return apply_fn()
                finally:
                    self.engine.flush()

    def update_stager(self, stats=None):
        """This plane's planned-update stager, created on first use
        (kubedtn_tpu_torch.updates.stager.UpdateStager). `stats`
        attaches an UpdateStats sink the first time one is offered."""
        from kubedtn_tpu_torch.updates.stager import UpdateStager

        with self._tick_lock:
            if self._update_stager is None:
                self._update_stager = UpdateStager(self, stats=stats)
            elif stats is not None and self._update_stager.stats is None:
                self._update_stager.stats = stats
            return self._update_stager

    def fast_forward(self, sim_seconds: float,
                     dt_s: float | None = None) -> dict:
        """Advance the plane by `sim_seconds` of VIRTUAL time without
        sleeping. Ticks a synthetic clock forward in `dt_s` steps
        (default: the plane's period) from the last tick's clock; frame
        releases land on the first tick at/after their deadline, so
        delivery timestamps are quantized to dt_s. Must not run while
        the real-time runner is active (their clocks would disagree)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "fast_forward with the real-time runner active would mix "
                "the monotonic and synthetic clocks; stop() it first")
        dt = dt_s if dt_s is not None else self.dt_us / 1e6
        if dt <= 0:
            raise ValueError(f"dt_s must be positive: {dt}")
        t = self.last_now_s if self.last_now_s is not None else 0.0
        end = t + sim_seconds
        t0_ticks, t0_shaped = self.ticks, self.shaped
        wall0 = time.monotonic()
        self._ff_active = True  # start() refuses while the loop runs
        try:
            while t < end:
                t = min(t + dt, end)
                self.tick(now_s=t)
            # pipeline barrier: with pipeline_explicit_clock set, the
            # last tick's dispatch may still be in flight — its frames
            # must be scheduled (and counted) before this returns
            with self._tick_lock:
                self.flush()
                self._release(t if self.last_now_s is None
                              else self.last_now_s)
        finally:
            self._ff_active = False
        wall_s = time.monotonic() - wall0
        ticks = self.ticks - t0_ticks
        return {
            "sim_seconds": sim_seconds,
            "ticks": ticks,
            "shaped": self.shaped - t0_shaped,
            "virtual_clock_s": t,
            "wall_s": round(wall_s, 3),
            "virtual_speedup": round(sim_seconds / wall_s, 2)
            if wall_s > 0 else None,
            "ticks_per_s": round(ticks / wall_s, 1) if wall_s > 0
            else None,
        }

    @requires_lock("_tick_lock")
    def _tick_inner(self, now_s: float | None) -> int:
        # an explicit clock marks the plane as running on synthetic time
        # (tests, fast_forward); start() rebases before mixing in the
        # monotonic clock
        explicit = now_s is not None
        self._clock_ext = explicit
        if now_s is None:
            now_s = time.monotonic()
        if self._origin_s is None:
            self._origin_s = now_s
        self.last_now_s = now_s
        stage = self.stage_s
        # Explicit-clock ticks always drain at max_slots and run
        # SYNCHRONOUS unless pipeline_explicit_clock opts in; runner
        # ticks use the adaptive budget and keep up to depth-1
        # dispatches in flight. The degradation ladder caps the
        # effective depth at 1 below level 0.
        depth = self.effective_pipeline_depth
        pipelined = depth > 1 and (
            not explicit or self.pipeline_explicit_clock)
        budget = self.max_slots if explicit else self._drain_budget
        t0 = time.perf_counter()
        # tenancy: QoS drain weights + admission throttling resolve to
        # ONE per-wire budget callable (0 = tenant over budget, wire
        # skipped this tick with a typed verdict, frames kept queued)
        admit = (self.tenancy.drain_policy(budget, now_s)
                 if self.tenancy is not None else None)
        drained = self.daemon.drain_ingress(max_per_wire=budget,
                                            skip=self._holdback.keys()
                                            if self._holdback else None,
                                            admit=admit)
        if drained and self.tenancy is not None:
            # batch-granular debit: what was drained was admitted
            self.tenancy.charge_drained(drained, now_s)
        stage["drain"] += time.perf_counter() - t0
        if not explicit:
            self._adapt_budget()
        dispatched = False
        if drained or self._holdback:
            job = self._dispatch(drained, now_s)
            if job is not None:
                self._inflight.append(job)
                dispatched = True
        if not dispatched and self.telemetry is not None:
            # idle tick: the window clock still advances (rollover
            # happens at dispatch otherwise)
            self.telemetry.touch(now_s)
        # consume completed pipeline stages: with a fresh dispatch in the
        # ring, everything beyond depth-1 in-flight jobs completes now —
        # the PREVIOUS tick's job, whose device work overlapped this
        # tick's host work. An idle tick drains the ring completely, so
        # tail frames never wait on traffic that may not come.
        shaped = 0
        limit = depth - 1 if pipelined and dispatched else 0
        while len(self._inflight) > limit:
            shaped += self._complete_or_requeue(self._inflight.popleft())
        if self._need_resync and self._inflight:
            # a TBF fallback re-shape rewrote rows a newer in-flight
            # dispatch shaped against: drain the pipeline so the next
            # dispatch reads the corrected engine state
            while self._inflight:
                shaped += self._complete_or_requeue(
                    self._inflight.popleft())
        self._need_resync = False
        if not self._inflight:
            self._pipe_state = None
        t2 = time.perf_counter()
        self._release(now_s)
        stage["release"] += time.perf_counter() - t2
        self.ticks += 1
        return shaped

    @requires_lock("_tick_lock")
    def _adapt_budget(self) -> None:
        """Backpressure-aware drain budget (runner ticks only): while the
        post-drain ingress backlog GROWS across the sliding window,
        double toward max_slots; while it stays empty, halve toward
        adapt_min_slots for tight per-frame latency."""
        bl = getattr(self.daemon, "last_drain_backlog", 0)
        self.last_backlog = bl
        win = self._bl_win
        win.append(bl)
        if bl and len(win) == win.maxlen and bl >= win[0] and bl > 0:
            if self._drain_budget < self.max_slots:
                self._drain_budget = min(self._drain_budget * 2,
                                         self.max_slots)
        elif not bl and len(win) == win.maxlen and not any(win):
            if self._drain_budget > self.adapt_min_slots:
                self._drain_budget = max(self._drain_budget // 2,
                                         self.adapt_min_slots)

    def stage_breakdown(self) -> dict:
        """Cumulative per-stage tick seconds plus each stage's share of
        the total (see `stage_s`), the pipeline posture beside them."""
        from kubedtn_tpu_torch.utils.tracing import stage_shares

        out = stage_shares(self.stage_s)
        out["ticks"] = self.ticks
        out["pipeline"] = {
            "depth": self.pipeline_depth,
            "effective_depth": self.effective_pipeline_depth,
            "degrade_level": self.degrade_level,
            # dtnlint: lock-ok(metrics gauge snapshot: len/int reads are torn-read tolerant and must not block behind a wedged dispatch holding the tick lock)
            "inflight": len(self._inflight),
            "drain_budget": self._drain_budget,  # dtnlint: lock-ok(gauge snapshot, see above)
            "ingress_backlog": self.last_backlog,
            "holdback_wires": len(self._holdback),  # dtnlint: lock-ok(gauge snapshot, see above)
        }
        return out

    # -- fault-domain supervision --------------------------------------

    @property
    def effective_pipeline_depth(self) -> int:
        """Configured depth at ladder level 0; 1 on any degraded rung."""
        return self.pipeline_depth if self.degrade_level == 0 else 1

    @property
    def heartbeat_age_s(self) -> float | None:
        """Seconds since the runner's last loop iteration (None while no
        runner is live) — the watchdog's stall signal."""
        hb = self._heartbeat_s
        return None if hb is None else time.monotonic() - hb

    @property
    def watchdog_stalled(self) -> bool:
        """Is the runner CURRENTLY stalled past the watchdog timeout
        (armed watchdog only)? The live half of the grpc.health.v1
        NOT_SERVING verdict."""
        if not self._watchdog_armed:
            return False
        age = self.heartbeat_age_s
        return age is not None and age > self.watchdog_timeout_s

    def health(self) -> dict:
        """The plane-local slice of the Local.Health surface. Every field
        is a torn-read-tolerant gauge snapshot: this must answer even
        while a wedged dispatch holds the tick lock."""
        from kubedtn_tpu_torch import native

        return {
            "running": self.running,
            "heartbeat_age_s": self.heartbeat_age_s,
            "watchdog_stalls": self.watchdog_stalls,
            "watchdog_stalled": self.watchdog_stalled,
            "degrade_level": self.degrade_level,
            "tick_errors": self.tick_errors,
            "ticks": self.ticks,
            "backlog": self.last_backlog,
            # dtnlint: lock-ok(gauge snapshot: len/int reads are torn-read tolerant and must not block behind a wedged dispatch holding the tick lock)
            "holdback_wires": len(self._holdback),
            "inflight": len(self._inflight),  # dtnlint: lock-ok(gauge snapshot, see above)
            "pipeline_depth": self.pipeline_depth,
            "effective_depth": self.effective_pipeline_depth,
            # serving = what the generic grpc.health.v1 probe reports:
            # NOT_SERVING while the degradation ladder sits at its
            # bottom rung or the runner is stalled past the watchdog
            "serving": not (self.degrade_level >= 2
                            or self.watchdog_stalled),
            # frame materialization in C (native.kdt_ext), or in Python
            # where the interpreter's headers did not resolve
            "kdt_ext": native.kdt_ext() is not None,
        }

    def attach_chaos(self, injector) -> None:
        """Wire a chaos.ChaosInjector into this plane's fault domains:
        the per-peer egress RPCs and the dispatch hook."""
        self.chaos = injector
        injector.install_peer_faults(self.daemon)

    def attach_tenancy(self, registry) -> None:
        """Wire a tenancy.TenantRegistry into this plane: admission
        buckets + QoS drain weights enforce at every tick's drain, and
        the daemon's Local.Tenant* RPCs answer from it. The registry
        already steers the engine's row allocator (it attached itself
        at construction)."""
        self.tenancy = registry
        registry.plane = self
        self.daemon.tenancy = registry

    def attach_shm(self, ingest, watcher: bool = True) -> None:
        """Wire a shm.ShmIngest into this plane: every drain folds the
        attached rings' committed frames in (admission at the ring
        head), and the watcher thread wakes the runner on ring traffic
        as mark_hot does for gRPC ingress. Pass watcher=False under an
        explicit clock (the caller drives the ticks)."""
        self.daemon.shm = ingest
        if watcher:
            ingest.start_watcher(self.daemon)

    def peer_fault_stats(self) -> dict[str, dict]:
        """Per-peer breaker / retry / outage-buffer snapshot. Snapshot
        via list(): the tick thread inserts senders on first traffic to
        a new peer."""
        out: dict[str, dict] = {}
        for addr, s in list(self._peer_senders.items()):
            b = s.breaker
            out[addr] = {
                "state": b.state,
                "opens": b.opens,
                "half_opens": b.half_opens,
                "closes": b.closes,
                "cycles": b.cycles,
                "retries": s.retries,
                "sent": s.sent,
                "buffered": s.buffered,
                "dropped": s.dropped,
            }
        return out

    @property
    def peer_retries(self) -> int:
        """Transient peer-send retry attempts, summed over peers."""
        return sum(s.retries for s in list(self._peer_senders.values()))

    def force_degrade(self, level: int) -> None:
        """Step the degradation ladder to `level` (0 = full pipeline,
        1 = depth-1, 2 = synchronous un-fused). Crosses the flush()
        barrier under the tick lock, so the transition never splits an
        in-flight dispatch — delivery order stays byte-identical to a
        run pinned at either level."""
        level = max(0, min(2, int(level)))
        with self._tick_lock:
            if level == self.degrade_level:
                return
            self.flush()
            if level > self.degrade_level:
                self.degradations += 1
            else:
                self.promotions += 1
            prev, self.degrade_level = self.degrade_level, level
            self._last_transition_s = time.monotonic()
        from kubedtn_tpu_torch.utils.logging import fields, get_logger

        get_logger("dataplane").warning(
            "degradation ladder %s", fields(
                from_level=prev, to_level=level,
                effective_depth=self.effective_pipeline_depth,
                tick_errors=self.tick_errors))

    def _safe_supervise(self, ok: bool) -> None:
        """_supervise that can never kill the runner: a ladder transition
        crosses flush(), whose completions can re-raise the very device
        error being supervised. The transition retries on a later tick;
        _complete_or_requeue already preserved the frames."""
        try:
            self._supervise(ok)
        except Exception:
            from kubedtn_tpu_torch.utils.logging import fields, get_logger

            get_logger("dataplane").exception(
                "supervisor transition failed (continuing) %s",
                fields(degrade_level=self.degrade_level,
                       tick_errors=self.tick_errors))

    def _supervise(self, ok: bool) -> None:
        """Runner-loop supervisor: degrade_after consecutive tick
        failures step the ladder down one rung; a clean promote_after_s
        interval re-promotes one rung at a time."""
        now = time.monotonic()
        if ok:
            self._consec_fail = 0
            if (self.degrade_level > 0
                    and (self._last_fail_s is None
                         or now - self._last_fail_s
                         >= self.promote_after_s)
                    and (self._last_transition_s is None
                         or now - self._last_transition_s
                         >= self.promote_after_s)):
                self.force_degrade(self.degrade_level - 1)
        else:
            self._last_fail_s = now
            self._consec_fail += 1
            if (self._consec_fail >= self.degrade_after
                    and self.degrade_level < 2):
                self._consec_fail = 0
                self.force_degrade(self.degrade_level + 1)

    @requires_lock("_tick_lock")
    def _requeue_failed(self, items, decided: bool) -> None:
        """Put a failed dispatch's frames back where the next tick will
        shape them — a tick failure must degrade, never lose frames.
        Already-decided frames (and holdback residue) go to the holdback
        buffer so they keep their count-and-decide-exactly-once verdict;
        fresh undecided frames return to the FRONT of their ingress
        deque (still FIFO, they classify on their next drain)."""
        if not items:
            return
        for it in items:
            if len(it) == 5:
                wire, _row, lens, fr, pd = it
            else:
                wire, lens, fr, pd = it
            if pd or decided:
                prev = self._holdback.get(wire.wire_id)
                if prev is not None:
                    self._holdback[wire.wire_id] = (
                        wire, _cat_lens(lens, prev[1]),
                        list(fr) + list(prev[2]))
                else:
                    self._holdback[wire.wire_id] = (wire, lens, list(fr))
            else:
                wire.ingress.extendleft(reversed(fr))
        if self._holdback:
            self._wake.set()

    @requires_lock("_tick_lock")
    def _dispatch(self, drained, now_s: float) -> _ShapeJob | None:
        """Front half of one tick's shaping: classify + bypass-decide on
        the host, then issue the whole tick's device program (one
        fused_tick, or per-class dispatches at degradation level 2). The
        returned _ShapeJob holds the outputs on their way to the host —
        this path never blocks on the device. Any failure requeues the
        drained frames (ingress front / holdback) before propagating."""
        # holdback (seq-cap residue from the previous tick) shapes FIRST,
        # ahead of freshly drained frames, and skips the bypass decision
        inputs: list[tuple[object, list[int], list[bytes], bool]] = []
        if self._holdback:
            holdback, self._holdback = self._holdback, {}
            for wire, lens, fr in holdback.values():
                inputs.append((wire, lens, fr, True))
        for wire, _row, lens, frames_list in drained:
            inputs.append((wire, lens, frames_list, False))
        self._disp_items = inputs
        self._disp_decided = False
        try:
            return self._dispatch_inner(inputs, now_s)
        except Exception:
            rec = self.recorder
            if rec is not None and self._disp_samp_adv is not None:
                if self._disp_decided:
                    # frames requeue PREDECIDED (holdback) and will not
                    # re-sample: terminate their traces explicitly
                    for sm in (self._disp_samples or []):
                        for _off, tid in sm:
                            rec.record(tid, tele.ST_REQUEUED,
                                       reason="dispatch-fault")
                else:
                    # frames return to the ingress FRONT and re-drain:
                    # roll the per-row counters back so the retry replays
                    # the exact sampling schedule
                    for sm in (self._disp_samples or []):
                        for _off, tid in sm:
                            rec.record(tid, tele.ST_REQUEUED,
                                       reason="dispatch-fault-retry")
                    for row, m, n in self._disp_samp_adv:
                        rec.unsample_batch(row, m, n)
            self._requeue_failed(self._disp_items, self._disp_decided)
            raise
        finally:
            self._disp_items = None
            self._disp_samples = None
            self._disp_samp_adv = None

    @requires_lock("_tick_lock")
    def _dispatch_inner(self, inputs, now_s: float) -> _ShapeJob | None:
        if self.chaos is not None:
            # deterministic fault injection (tests / chaos runs): raising
            # here exercises the requeue path plus the supervisor
            self.chaos.on_dispatch()
        from kubedtn_tpu_torch import native
        from kubedtn_tpu_torch.wire.server import FrameSeg, flatten_frames

        engine = self.engine
        # -- snapshot under the engine lock -----------------------------
        with engine._lock:
            state = engine.state  # flushes pending control-plane ops
            E = state.capacity
            if self.counters.tx_packets.shape[0] != E:
                # the engine grew: its rows keep their cumulative counts
                # (the JAX plane starts every row from zero here; see
                # _grown_counters)
                self.counters = _grown_counters(self.counters, E)
            # Rows are re-resolved HERE, under the lock — the drain's
            # row values are advisory and compact() may have renumbered
            # rows since. A wire whose link vanished re-queues.
            batches: list[tuple[object, int, list[int], list[bytes],
                                bool]] = []
            requeue = []
            for wire, lens, frames_list, predecided in inputs:
                fresh = engine._rows.get((wire.pod_key, wire.uid))
                if fresh is None:
                    requeue.append((wire, lens, frames_list, predecided))
                    continue
                batches.append((wire, fresh, lens, frames_list,
                                predecided))
            # frames entering a directed edge exit at the PEER pod's
            # wire (the reference writes into the peer's pod-side veth,
            # grpcwire.go:256-271)
            rowinfo: dict[int, tuple[str, int] | None] = {}
            # per-row identity keys of the keyed draws
            # (engine.link_key_id; 0 for a row the registry lost)
            keyid_map: dict[int, int] = {}
            keyid_col = engine._row_keyid
            for _w, row, _lens, _fr, _pd in batches:
                key = engine._row_owner.get(row)
                rowinfo[row] = (engine._peer.get(key, key)
                                if key is not None else None)
                keyid_map[row] = int(keyid_col[row])
            shaped_all = engine._shaped_rows
            shaped_rows = {b[1] for b in batches if b[1] in shaped_all}
            dstrow: dict[int, int] = {}
            if self._shard_mesh is not None:
                # destination (peer) edge rows, for the cross-shard frame
                # accounting
                for row, target in rowinfo.items():
                    dr = (engine._rows.get(target)
                          if target is not None else None)
                    dstrow[row] = -1 if dr is None else dr
            # chained dynamic columns must match the snapshot capacity;
            # engine growth mid-pipeline drains the ring right here
            if (self._pipe_state is not None
                    and self._pipe_state[0].shape[0] != E):
                while self._inflight:
                    self._complete_or_requeue(self._inflight.popleft())
                self._pipe_state = None
            # Rows the control plane re-initialized since the last
            # dispatch: older in-flight write-backs must not resurrect
            # pre-touch dynamics (touched_after), and the chained columns
            # are patched to the engine's fresh values (into NEW tensors:
            # the chain head is an in-flight job's output) so THIS
            # dispatch shapes them from their re-initialized state.
            # compact() raises the whole-capacity form as a FLAG.
            if engine._touched_all:
                for j in self._inflight:
                    j.touched_all = True
                if self._pipe_state is not None:
                    self._pipe_state = _dyn_of(state)
                engine._touched_all = False
            touched = engine._rows_touched
            if touched:
                for j in self._inflight:
                    j.touched_after |= touched
                if self._pipe_state is not None:
                    tidx = _stage_in(np.array(sorted(touched), np.int64),
                                     state.device)
                    self._pipe_state = tuple(
                        col.index_copy(0, tidx, src.index_select(0, tidx))
                        for col, src in zip(self._pipe_state,
                                            _dyn_of(state)))
                touched.clear()
        for wire, lens, frames_list, predecided in requeue:
            if self.daemon.wires.get_by_id(wire.wire_id) is None:
                # the wire itself was deregistered mid-flight: count the
                # frames instead of leaking silently
                self.undeliverable += len(lens)
            elif predecided:
                # holdback residue whose row vanished mid-wait: back into
                # _holdback, NOT wire.ingress (count-and-decide-once)
                prev = self._holdback.get(wire.wire_id)
                if prev is not None:
                    self._holdback[wire.wire_id] = (
                        wire, _cat_lens(lens, prev[1]),
                        frames_list + prev[2])
                else:
                    self._holdback[wire.wire_id] = (wire, lens,
                                                    frames_list)
            else:
                wire.ingress.extendleft(reversed(frames_list))
        if not batches:
            return None
        # vanished-row frames are requeued above; from here a failure
        # requeues the surviving batches instead of the raw inputs
        self._disp_items = batches

        # -- flight-recorder sampling (deterministic, O(batches)) ------
        rec = self.recorder
        samples: list[list] | None = None
        if rec is not None:
            samples = []
            samp_adv = []
            for w, row, lens, _fr, pd in batches:
                if pd:
                    samples.append([])
                    continue
                sm = rec.sample_batch(row, len(lens))
                samp_adv.append((row, len(lens), len(sm)))
                # carried ids (shm ingest: a producer's sampled trace
                # rode the slot layout here) join the batch's samples
                # under the SAME id; they are not counter-derived, so
                # samp_adv (the requeue rollback) excludes them
                base = 0
                for p in _fr:
                    if type(p) is FrameSeg:
                        tr = p.traces
                        if tr:
                            sm.extend((base + (k - p.lo), tid)
                                      for k, tid in tr
                                      if p.lo <= k < p.hi)
                        base += len(p)
                    else:
                        base += 1
                for _off, tid in sm:
                    rec.record(tid, tele.ST_INGRESS, row=row,
                               wire=w.wire_id, batch=len(lens))
                samples.append(sm)
            self._disp_samples = samples
            self._disp_samp_adv = samp_adv

        # -- vectorized bypass decision OUTSIDE the engine lock --------
        # (eBPF sockops/redir semantics), fused with the per-protocol
        # classification (frame_stats) in ONE native call. A frame is
        # counted exactly once — on its first decide pass.
        t_decide0 = time.perf_counter()
        ft = self._flowtable
        ptr_parts: list[np.ndarray] = []
        lens_parts: list[np.ndarray] = []
        # per-batch flags, repeated over the batch's frames below
        n_fr, elig, shp, cnt = [], [], [], []
        for _w, row, lens, fr, predecided in batches:
            target = rowinfo.get(row)
            ok = False
            if target is not None and not predecided:
                # sockops redirection is strictly SAME-NODE; holdback
                # frames already took their verdict when first drained
                peer_wire = self.daemon.wires.get_by_key(*target)
                ok = peer_wire is not None and not peer_wire.peer_ip
            m = len(lens)
            # frame pointers: FrameSeg windows are base+offset vector
            # adds; runs of plain bytes marshal through one c_char_p
            # array (the frames stay referenced via `batches`)
            run: list[bytes] = []
            for p in fr:
                if type(p) is FrameSeg:
                    if run:
                        ptr_parts.append(native.frame_ptrs_u64(run))
                        run = []
                    ptr_parts.append(p.ptrs())
                else:
                    run.append(p)
            if run:
                ptr_parts.append(native.frame_ptrs_u64(run))
            lens_parts.append(np.asarray(lens, np.uint64))
            n_fr.append(m)
            elig.append(ok)
            shp.append(row in shaped_rows)
            cnt.append(not predecided)
        n_fr = np.asarray(n_fr, np.int64)
        decide, class_stats = ft.decide_classify_ptrs(
            np.concatenate(ptr_parts), np.concatenate(lens_parts),
            *(np.repeat(np.asarray(f, np.uint8), n_fr)
              for f in (elig, shp, cnt)))
        if class_stats:
            self.daemon.frame_stats.update(class_stats)
        # every frame has now taken its exactly-once classify/count
        # verdict: a later failure must requeue via holdback
        self._disp_decided = True
        if decide.any():
            # split FIRST (pure host work), deliver after: a failure
            # mid-delivery then requeues only the kept batches
            pos = 0
            kept_batches = []
            kept_samples: list[list] = []
            deliveries = []
            for bi, (w, row, lens, fr, pd) in enumerate(batches):
                m = len(lens)
                d = decide[pos:pos + m]
                pos += m
                if d.any():
                    ff = flatten_frames(fr)
                    by = [f for f, dd in zip(ff, d) if dd]
                    deliveries.append((rowinfo[row], by))
                    kl = [int(ln) for ln, dd in zip(lens, d) if not dd]
                    kf = [f for f, dd in zip(ff, d) if not dd]
                    if samples is not None:
                        # shift kept samples past the extracted bypass
                        # frames; bypassed traces end here
                        cum = np.cumsum(d)
                        sm = []
                        for off, tid in samples[bi]:
                            if d[off]:
                                rec.record(tid, tele.ST_BYPASS, row=row)
                                rec.record(tid, tele.ST_DELIVERED,
                                           via="bypass")
                            else:
                                sm.append((off - int(cum[off]), tid))
                        if kf:
                            kept_samples.append(sm)
                    if kf:
                        kept_batches.append((w, row, kl, kf, pd))
                else:
                    kept_batches.append((w, row, lens, fr, pd))
                    if samples is not None:
                        kept_samples.append(samples[bi])
            batches = kept_batches
            if samples is not None:
                samples[:] = kept_samples  # in place: _dispatch holds it
            self._disp_items = batches
            for target, by in deliveries:
                # latency ~ 0: delivered in the same tick. Guarded per
                # batch: a capture-tap failure (disk full) must not
                # abort the dispatch — the egress extend happens before
                # the tap, so the frames are counted, not redelivered
                try:
                    self.bypassed += self.daemon.deliver_egress_bulk(
                        *target, by)
                except Exception:
                    self.undeliverable += len(by)
        self.stage_s["decide"] += time.perf_counter() - t_decide0
        if not batches:
            return None

        # -- cross-shard frame accounting (sharded planes) -------------
        if self._shard_mesh is not None:
            n_sh = len(self._shard_mesh)
            if n_sh > 1 and E % n_sh == 0:
                loc = E // n_sh
                x = 0
                for _w, row, lens_i, _fr, _pd in batches:
                    dr = dstrow.get(row, -1)
                    if dr >= 0 and dr // loc != row // loc:
                        x += len(lens_i)
                self.shard_xfrm += x
                self.shard_xfrm_last = x

        # -- route rows: slot-independent vs TBF-batch vs sequential ---
        # via the HOST mirror of the props table, refreshed once per
        # engine props generation (T1: never keyed on tensor identity)
        rows_np = np.fromiter((b[1] for b in batches), np.int64,
                              count=len(batches))
        gen, mirror = self._props_cache
        if gen != engine.props_gen or mirror is None \
                or mirror.shape[0] != E:
            gen = engine.props_gen
            # dtnlint: sync-ok(cached host mirror — one transfer per props generation, not per tick; the cache replaced the old per-tick gather)
            mirror = state.props.cpu().numpy()
            self._props_cache = (gen, mirror)
        props_rows = mirror[rows_np]
        indep = np.asarray(netem.slot_independent_rows(props_rows), bool)
        tbfb = np.asarray(netem.tbf_batch_rows(props_rows), bool)
        # Predecided (requeued-residue) TBF batches go straight to the
        # sequential scan; fresh TBF traffic takes the max-plus core, and
        # the rare 50ms-queue-drop fallback re-shapes at completion
        seq_group = [i for i in range(len(batches))
                     if not indep[i] and (not tbfb[i] or batches[i][4])]
        tbf_group = [i for i in range(len(batches))
                     if tbfb[i] and not batches[i][4]]
        ind_group = [i for i in range(len(batches)) if indep[i]]

        # sequential rows bound the scan length: the residue waits in the
        # plane's holdback buffer and shapes first next tick
        cap = self.seq_slots
        for i in seq_group:
            w, row, lens, fr, pd = batches[i]
            if len(lens) > cap:
                fr_head, fr_tail = _split_parts(fr, cap)
                self._holdback[w.wire_id] = (w, lens[cap:], fr_tail)
                batches[i] = (w, row, lens[:cap], fr_head, pd)
                deferred = len(lens) - cap
                if self.telemetry is not None:
                    # per-edge shaping-queue depth: frames this tick
                    # deferred to the holdback buffer
                    self.telemetry.patch_add(row, tele.T_QDEPTH, deferred)
                if samples is not None:
                    sm = []
                    for off, tid in samples[i]:
                        if off < cap:
                            sm.append((off, tid))
                        else:
                            rec.record(tid, tele.ST_REQUEUED,
                                       reason="seq-cap", row=row)
                    samples[i] = sm
        if self._holdback:
            self._wake.set()

        # -- the tick's device program ---------------------------------
        # The persistent shaping clocks advance INSIDE the program by the
        # wall time since the epoch of the dynamics it chains from: the
        # chain head when pipelined, the engine's last write-back
        # otherwise.
        prev = (self._chain_shaped_s if self._pipe_state is not None
                else self._last_shaped_s)
        elapsed_us = (0.0 if prev is None
                      else max(0.0, (now_s - prev) * 1e6))
        job = _ShapeJob(now_s, (now_s - self._origin_s) * 1e6, now_s,
                        prev, batches, rowinfo, E)
        job.samples = samples
        t_kernel0 = time.perf_counter()
        dev = state.device
        host_args, args = {}, {}
        for kind, group in (("seq", seq_group), ("tbf", tbf_group),
                            ("ind", ind_group)):
            if group:
                host_args[kind] = _group_arrays(batches, group, E,
                                                keyid_map)
                args[kind] = tuple(_stage_in(a, dev)
                                   for a in host_args[kind])
        if self._shard_mesh is not None:
            # every padded batch row rides the mailbox once per ring step
            mail_rows = sum(a[0].shape[0] for a in host_args.values())
            self.shard_mailbox_hwm = max(self.shard_mailbox_hwm,
                                         mail_rows)
        dyn_in = self._pipe_state
        if "tbf" in args:
            # the TBF rows as this dispatch shapes them from (before the
            # clock roll), for the fallback re-shape at completion
            src = state if dyn_in is None else _with_dyn(state, dyn_in)
            rows_t = args["tbf"][0]
            job.tbf_pre = {f: netem.gather_rows(getattr(src, f), rows_t)
                           for f in ROW_FIELDS}
        # link-telemetry window accumulator: fetched under the tick lock
        # (rollover happens here, on the dispatch clock) and chained
        # through the program like the dynamic columns
        tel_in = (self.telemetry.open_acc(now_s, E)
                  if self.telemetry is not None else None)
        job.has_tel = tel_in is not None
        if self.degrade_level >= 2:
            # synchronous un-fused ladder rung: one dispatch per kernel
            # class, chained host-side in the fused program's order with
            # the SAME key split — byte-identical outputs
            key, sub = split(self._key)
            dyn = dyn_in
            tel_out = tel_in
            el = elapsed_us
            outs = {}
            for kind in CLASS_ORDER:
                a = args.get(kind)
                if a is None:
                    continue
                dyn, outs[kind], tel_out = class_tick(
                    state, dyn, sub, el, a, tel_out, kind=kind)
                el = 0.0  # the clock roll applies once
            dyn_after = dyn
        elif self._shard_mesh is not None:
            from kubedtn_tpu_torch.convert import shard, unshard

            mesh = self._shard_mesh
            src = state if dyn_in is None else _with_dyn(state, dyn_in)
            key, sub, dyn_sh, outs, tel_sh = self._sharded_fused(
                shard(src, mesh), None, self._key, elapsed_us,
                args.get("seq"), args.get("tbf"), args.get("ind"),
                None if tel_in is None else shard(tel_in, mesh))
            dyn_after = unshard(dyn_sh, dev)
            tel_out = None if tel_sh is None else unshard(tel_sh, dev)
        else:
            key, sub, dyn_after, outs, tel_out = fused_tick(
                state, dyn_in, self._key, elapsed_us,
                args.get("seq"), args.get("tbf"), args.get("ind"),
                tel_in)
        if self._exchange_probe is not None and args:
            self._exchange_count += 1
            if self._exchange_count % 64 == 1:
                self._run_exchange_probe(
                    max(a[1].shape[0] for a in host_args.values()))
        if job.has_tel:
            self.telemetry.set_acc(tel_out)
        self._key = key
        job.sub = sub
        job.dyn_after = dyn_after
        self._pipe_state = dyn_after
        self._chain_shaped_s = now_s
        for kind, group in (("tbf", tbf_group), ("seq", seq_group),
                            ("ind", ind_group)):
            if group:
                job.groups.append((kind, group, *host_args[kind],
                                   _HostOuts(outs[kind])))
        self.stage_s["kernel"] += time.perf_counter() - t_kernel0
        return job

    @requires_lock("_tick_lock")
    # dtnlint: sync-ok(the pipeline's designated sync point: _complete consumes a dispatched tick's device outputs)
    def _complete(self, job: _ShapeJob) -> int:
        """Back half of a tick's shaping: wait for one job's outputs (the
        pipeline's only sync point), run the rare TBF 50ms-queue-drop
        fallback re-shape, merge the dynamic columns back into the
        engine, schedule releases on the timing wheel, and accumulate
        per-row counters. Returns the frames this job delivered into the
        delay line."""
        engine = self.engine
        batches = job.batches
        rowinfo = job.rowinfo
        t_sync0 = time.perf_counter()
        np_groups = [(kind, group, row_idx, sizes, valid, key_ids,
                      outs.wait())
                     for kind, group, row_idx, sizes, valid, key_ids, outs
                     in job.groups]
        self.stage_s["sync"] += time.perf_counter() - t_sync0

        # -- TBF fallback --------------------------------------------
        # A batch that trips the 50ms queue drop breaks the max-plus
        # core's linearity (a dropped packet charges no tokens): re-shape
        # those rows' WHOLE batches with the exact sequential scan, from
        # the same pre-batch bucket state the detection run read
        # (job.tbf_pre + this tick's clock roll — the detection
        # write-back skipped fallback rows). The draws use the tick's
        # sub-key under the class id netem.CLASS_FALLBACK. The corrected
        # dynamics override dyn_after at write-back below.
        corrected = None
        for g in np_groups:
            kind, group, row_idx, sizes, valid, key_ids, arrs = g
            if kind != "tbf":
                continue
            fbk_dev = arrs[5][:len(group)].astype(bool)
            fbk = fbk_dev
            forced = job.force_rows
            if forced:
                # rows an older job's fallback corrected AFTER this
                # dispatch: redo them with the exact scan exactly like a
                # device-detected fallback
                fbk = fbk | np.isin(
                    row_idx[:len(group)],
                    np.fromiter(forced, np.int64, len(forced)))
            if not fbk.any():
                continue
            sel = np.nonzero(fbk)[0]
            self.fallbacks += len(sel)
            dev = job.tbf_pre["props"].device
            sel_t = _stage_in(sel.astype(np.int64), dev)
            pre = {f: v.index_select(0, sel_t)
                   for f, v in job.tbf_pre.items()}
            if forced:
                # splice the CORRECTED engine columns in for the forced
                # rows before the epoch roll: completions are FIFO and
                # each one writes back, so the engine's epoch here
                # equals prev_shaped_s and the shared roll below is exact
                # for both. (Capacity mismatch = engine grew mid-flight;
                # growth already drains the ring, skip the splice.)
                fpos = [j for j, r in enumerate(sel.tolist())
                        if int(row_idx[r]) in forced]
                with engine._lock:
                    cur = engine._state
                if fpos and cur.capacity == job.capacity:
                    fp = _stage_in(np.array(fpos, np.int64), dev)
                    fr = _stage_in(row_idx[sel[fpos]].astype(np.int64),
                                   dev)
                    for f in DYN_FIELDS:
                        pre[f] = pre[f].index_copy(
                            0, fp, getattr(cur, f).index_select(0, fr))
            tl, bl = pre["t_last"], pre["backlog_until"]
            if job.prev_shaped_s is not None:
                el = max(0.0, (job.shaped_at - job.prev_shaped_s) * 1e6)
                if el > 0.0:
                    el = _f32(el)
                    tl = torch.clamp_min(tl - el, CLOCK_FLOOR_US)
                    bl = torch.clamp_min(bl - el, CLOCK_FLOOR_US)
            carry, res = netem.shape_rows_seq(
                pre["props"], pre["active"],
                (pre["tokens"], tl, bl, pre["corr"], pre["pkt_count"]),
                _stage_in(sizes[sel], dev), _stage_in(valid[sel], dev),
                job.sub, _stage_in(key_ids[sel], dev),
                cls=netem.CLASS_FALLBACK)
            fbouts = [x.cpu().numpy() for x in _out(res)]
            if job.has_tel and self.telemetry is not None:
                # window-ring correction for the re-shaped rows: the
                # device fold masked device-flagged fallback rows OUT
                # (their stats come from the exact scan, here), and
                # FORCED rows' stale detection-run stats are subtracted
                # before the corrected ones are added
                telm = self.telemetry
                for fj, r in enumerate(sel.tolist()):
                    row = int(row_idx[r])
                    if not fbk_dev[r]:
                        stale = tele.tel_row_host(
                            sizes[r], valid[r], arrs[0][r], arrs[1][r])
                        stale[tele.T_DROP_LOSS] = float(arrs[2][r])
                        stale[tele.T_DROP_QUEUE] = float(arrs[3][r])
                        stale[tele.T_CORRUPT] = float(arrs[4][r])
                        telm.patch_row(row, -stale)
                    cols = tele.tel_row_host(
                        sizes[r], valid[r], fbouts[0][fj], fbouts[1][fj])
                    cols[tele.T_DROP_LOSS] = float(fbouts[2][fj])
                    cols[tele.T_DROP_QUEUE] = float(fbouts[3][fj])
                    cols[tele.T_CORRUPT] = float(fbouts[4][fj])
                    telm.patch_row(row, cols)
            for a_i in range(5):
                arrs[a_i] = arrs[a_i].copy()  # private, writable
                arrs[a_i][sel] = fbouts[a_i]
            corrected = (row_idx[sel], carry)
            # forced rows that DID re-shape here consumed the corrected
            # state and advanced it — their write-back must land, so
            # lift the older job's touched_after protection for exactly
            # those rows
            job.touched_after -= (forced
                                  & {int(r) for r in row_idx[sel]})
            if self._inflight:
                # newer in-flight dispatches shaped these rows against
                # the uncorrected chain: keep the correction at their
                # write-back, redo their results at completion, and
                # _tick_inner drains the pipeline so the next dispatch
                # reads corrected engine state
                fbset = {int(r) for r in row_idx[sel]}
                for j2 in self._inflight:
                    j2.touched_after |= fbset
                    j2.force_rows |= fbset
                self._need_resync = True

        # -- write the dynamic columns back under the engine lock ------
        # into NEW tensors: dyn_after may be the chain head an in-flight
        # dispatch reads, and the engine's batch ops update its columns
        # in place
        dyn = job.dyn_after
        if corrected is not None:
            fidx, cols = corrected
            fidx = _stage_in(fidx.astype(np.int64), dyn[0].device)
            dyn = tuple(col.index_copy(0, fidx, val.to(col.dtype))
                        for col, val in zip(dyn, cols))
        with engine._lock:
            cur = engine._state
            if job.touched_all or engine._touched_all:
                # compact() renumbered every row since this job
                # dispatched: the write-back is a whole-state no-op —
                # keep the engine's (repacked) columns and only advance
                # the shaping clock
                if cur.capacity == dyn[0].shape[0]:
                    self._last_shaped_s = job.shaped_at
            elif cur.capacity == dyn[0].shape[0]:
                skip = job.touched_after
                if engine._rows_touched:
                    # touched after this job's dispatch but not yet
                    # drained by a newer dispatch: same merge-out rule
                    # (NOT cleared here — the next dispatch still needs
                    # to see and patch the chain for these rows)
                    skip = skip | engine._rows_touched
                if skip:
                    sidx = _stage_in(np.array(sorted(skip), np.int64),
                                     cur.device)

                    def merge(new, old):
                        return new.index_copy(0, sidx,
                                              old.index_select(0, sidx))
                else:
                    def merge(new, old):  # noqa: ARG001
                        return new.clone()
                engine._state = dataclasses.replace(cur, **{
                    f: merge(d, getattr(cur, f))
                    for f, d in zip(DYN_FIELDS, dyn)})
                self._last_shaped_s = job.shaped_at
            # else: engine grew mid-flight — drop this job's dynamic-
            # state advance rather than corrupt shapes; the results
            # below still schedule deliveries

        # -- schedule releases: batched wheel insert ------------------
        # per row, ONE pending entry [pod_key, uid, frames, deadlines,
        # remaining (, delay-line slot -> trace id)]; the deadlines and
        # the wheel tokens of all rows are built with vector ops
        # (row-major order of the delivered lanes == each entry's slot
        # order), and each entry keeps a view of its own deadlines so
        # the frames stay exportable (checkpointing)
        t_sched0 = time.perf_counter()
        shaped = 0
        deadline_parts: list[np.ndarray] = []
        token_parts: list[np.ndarray] = []
        base_us = job.base_us
        pending = self._pending
        rec = self.recorder
        for kind, group, row_idx, sizes, valid, _kids, arrs \
                in np_groups:
            R = len(group)
            dmask = arrs[0][:R]
            depart = arrs[1][:R]
            nd_all = dmask.sum(1)
            m_all = valid[:R].sum(1)
            n_shaped = int(nd_all.sum())
            shaped += n_shaped
            self.dropped += int(m_all.sum()) - n_shaped
            row_bseq = np.zeros(R, np.int64)
            for r, i in enumerate(group):
                _w, row, _lens, fr, _pd = batches[i]
                target = rowinfo.get(row)
                nd = int(nd_all[r])
                # flight recorder: sampled frames' kernel-class +
                # shaped/dropped(cause) verdicts; survivors carry their
                # trace into the delay-line entry for the release event
                tids = None
                if (rec is not None and job.samples is not None
                        and job.samples[i]):
                    tids = self._record_shaped(job.samples[i], kind, row,
                                               target, dmask[r], arrs, r)
                if nd == 0 or target is None:
                    continue
                m = int(m_all[r])
                if nd == m:
                    # whole batch survives: a segment batch defers
                    # materialization to release
                    has_segs = any(type(p) is not bytes for p in fr)
                    sel_frames = _LazyFrames(fr) if has_segs else list(fr)
                    slot_map = tids
                else:
                    if any(type(p) is not bytes for p in fr):
                        fr = _LazyFrames(fr).materialize()
                    idxs = np.nonzero(dmask[r])[0]
                    sel_frames = [fr[j] for j in idxs.tolist()]
                    slot_map = ({int(np.searchsorted(idxs, off)): tid
                                 for off, tid in tids.items()}
                                if tids else None)
                self._bseq += 1
                row_bseq[r] = self._bseq
                entry = [target[0], target[1], sel_frames, None, nd]
                if slot_map:
                    entry.append(slot_map)
                pending[self._bseq] = entry
            keep = row_bseq > 0
            if keep.any():
                lanes = dmask & keep[:, None]
                dls = base_us + depart[lanes].astype(np.float64)
                deadline_parts.append(dls)
                counts = nd_all[keep]
                ends = np.cumsum(counts)
                for b, e, n in zip(row_bseq[keep].tolist(), ends.tolist(),
                                   counts.tolist()):
                    pending[b][3] = dls[e - n:e]
                first = np.repeat(ends - counts, counts)
                slot = np.arange(int(counts.sum()), dtype=np.int64) - first
                token_parts.append(
                    ((np.repeat(row_bseq[keep], counts) << _TOK_BITS)
                     + slot).astype(np.uint64))
            self._accumulate_group(row_idx, sizes, valid, arrs)
        if deadline_parts:
            self._wheel.schedule_batch(np.concatenate(deadline_parts),
                                       np.concatenate(token_parts))
        self.stage_s["schedule"] += time.perf_counter() - t_sched0
        self.shaped += shaped
        return shaped

    def _record_shaped(self, samples, kind, row, target, drow, arrs, r):
        """The recorder's shaped / dropped(cause) events for one row's
        sampled frames; returns {offset: trace id} of the survivors."""
        rec = self.recorder
        tids = {}
        for off, tid in samples:
            rec.record(tid, tele.ST_SHAPED, kind=kind, row=row)
            if drow[off]:
                if target is None:
                    rec.record(tid, tele.ST_DROPPED, cause="no-target",
                               row=row)
                else:
                    tids[off] = tid
                continue
            # row-granular attribution from the [R] per-cause sums:
            # exact whenever the row saw a single drop cause this tick
            loss_n = float(arrs[2][r])
            queue_n = float(arrs[3][r])
            if loss_n and not queue_n:
                name = "dropped_loss"
            elif queue_n and not loss_n:
                name = "dropped_queue"
            elif loss_n and queue_n:
                name = f"mixed(loss={int(loss_n)},queue={int(queue_n)})"
            else:
                name = "tbf-fallback" if kind == "tbf" else "unknown"
            rec.record(tid, tele.ST_DROPPED, cause=name, row=row)
        return tids

    @requires_lock("_tick_lock")
    def _accumulate_group(self, row_idx, sizes, valid, arrs) -> None:
        """Accumulate one group's shaping results into the per-edge
        cumulative counters: row-indexed vector adds. The
        loss/queue/corrupt legs arrive as [R] per-row sums reduced on
        the device — the [R, K] drop masks never cross to the host.
        Padding rows (index >= the counter arrays) are masked out."""
        rows = np.asarray(row_idx, np.int64)
        c = self.counters
        keep = rows < c.tx_packets.shape[0]
        if not keep.any():
            return
        rows = rows[keep]
        vs = valid[keep]
        ss = sizes[keep]
        deliv = arrs[0][keep]
        # rows are unique within a group (one batch per wire)
        c.tx_packets[rows] += vs.sum(1).astype(np.float32)
        c.tx_bytes[rows] += (ss * vs).sum(1)
        c.rx_packets[rows] += deliv.sum(1).astype(np.float32)
        c.rx_bytes[rows] += (ss * deliv).sum(1)
        c.dropped_loss[rows] += arrs[2][keep]
        c.dropped_queue[rows] += arrs[3][keep]
        c.rx_corrupted[rows] += arrs[4][keep]

    # -- release ---------------------------------------------------------

    @requires_lock("_tick_lock")
    def _release(self, now_s: float) -> None:
        """ONE pass groups due frames by destination wire; delivery is
        then per-GROUP work (one egress extend, one lookup). Wheel
        release order is time-ordered; within a release per-wire FIFO
        order is preserved (appends happen in token order)."""
        groups: dict[tuple[str, int], list[bytes]] = {}
        setd = groups.setdefault
        rec = self.recorder
        traced: dict[tuple[str, int], dict[int, int]] = {}
        pending = self._pending
        toks = self._wheel.advance_np((now_s - self._origin_s) * 1e6)
        if toks.size:
            # Tokens arrive in wheel (time) order; runs of one batch id
            # are found with ONE vector op, then walked as Python lists
            # (a numpy call per run costs more than the run when
            # batches interleave, as TBF and jitter departures do). A
            # whole batch releasing at once in index order (every
            # latency-only batch) is a single list extend.
            bids = (toks >> np.uint64(_TOK_BITS)).astype(np.int64)
            cut = np.nonzero(np.diff(bids))[0] + 1
            starts = [0, *cut.tolist(), len(bids)]
            bl = bids[np.asarray(starts[:-1], np.int64)].tolist()
            il = (toks & np.uint64(_TOK_MASK)).astype(np.int64).tolist()
            for g, bid in enumerate(bl):
                a, b = starts[g], starts[g + 1]
                entry = pending[bid]
                key = (entry[0], entry[1])
                cur_list = setd(key, [])
                tmap = entry[5] if len(entry) > 5 else None
                frames_l = entry[2]
                lazy = type(frames_l) is _LazyFrames
                n = b - a
                sel = il[a:b]
                if n == entry[4] and (lazy or n == len(frames_l)) \
                        and sel == list(range(n)):
                    # full batch, token order == index order (a lazy
                    # entry can only be whole: any earlier partial
                    # release would have materialized it)
                    if tmap:
                        base = len(cur_list)
                        tdst = traced.setdefault(key, {})
                        for slot, tid in tmap.items():
                            tdst[base + slot] = tid
                    cur_list.extend(frames_l.materialize() if lazy
                                    else frames_l)
                    del pending[bid]
                    continue
                if lazy:
                    frames_l = entry[2] = frames_l.materialize()
                if tmap:
                    tdst = traced.setdefault(key, {})
                    base = len(cur_list)
                    for pos, i in enumerate(sel):
                        if i in tmap:
                            tdst[base + pos] = tmap.pop(i)
                cur_list.extend([frames_l[i] for i in sel])
                for i in sel:
                    frames_l[i] = None  # released: no longer exportable
                entry[4] -= n
                if entry[4] == 0:
                    del pending[bid]
        if self._orphans:
            # wires that appeared since last release get their waiting
            # frames; expired waits are counted, never silently dropped
            keep: deque[tuple[float, str, int, bytes]] = deque()
            while self._orphans:
                expire, pk, uid, frame = self._orphans.popleft()
                if self.daemon.wires.get_by_key(pk, uid) is not None:
                    setd((pk, uid), []).append(frame)
                elif now_s < expire:
                    keep.append((expire, pk, uid, frame))
                else:
                    self.undeliverable += 1
            self._orphans = keep
        staged = False
        ring_drops: dict[int, int] = {}
        cap = self.daemon.capture
        for wkey, frames in groups.items():
            wire = self.daemon.wires.get_by_key(*wkey)
            tmap = traced.get(wkey)
            if wire is None:
                expire = now_s + self.orphan_grace_s
                self._orphans.extend(
                    (expire, wkey[0], wkey[1], f) for f in frames)
                continue
            if wire.peer_ip:
                # stage for the per-peer stream batch below
                push = self._remote.push
                addr, intf = wire.peer_ip, wire.peer_intf_id
                for pos, frame in enumerate(frames):
                    tid = tmap.get(pos, 0) if tmap else 0
                    if push(addr, intf, frame, tid):
                        staged = True
                        if tid:
                            rec.record(tid, tele.ST_STAGED, peer=addr)
                    else:
                        # overflow: charge the drop to this frame's edge
                        # so it shows in the per-interface counters
                        row = self.engine._rows.get(wkey)
                        if row is not None:
                            ring_drops[row] = ring_drops.get(row, 0) + 1
                        if tid:
                            rec.record(tid, tele.ST_EGRESS_DROP,
                                       reason="ring-overflow")
            else:
                wire.egress.extend(frames)
                if tmap:
                    for _pos, tid in tmap.items():
                        rec.record(tid, tele.ST_DELIVERED,
                                   wire=wire.wire_id)
                if cap is not None:
                    for frame in frames:
                        cap.record(*wkey, frame, "out")
        if ring_drops:
            # one counter-array copy per release, however many frames fell
            dr = self.counters.dropped_ring.copy()
            for row, n in ring_drops.items():
                if row < dr.shape[0]:
                    dr[row] += np.float32(n)
            self.counters = dataclasses.replace(self.counters,
                                                dropped_ring=dr)
        if staged:
            self._flush_remote()

    # frames per coalesced PacketBatch message on the bulk transport
    BULK_CHUNK = 256

    def _flush_remote(self) -> None:
        """Hand all staged cross-node frames to their PER-PEER sender
        threads and return — the tick thread never blocks on a peer RPC
        (one slow peer must not eat the tick budget of every wire on the
        node; the reference gives each wire its own goroutine,
        grpcwire.go:386). Senders are created on first traffic to a peer
        and live until stop(); enqueue is bounded drop-and-count (like
        the staging ring), so a dead peer costs memory O(bound), not
        O(backlog)."""
        from kubedtn_tpu_torch.wire import proto as pb

        by_peer: dict[str, list] = {}
        traced_by_peer: dict[str, list] = {}
        while True:
            item = self._remote.pop()
            if item is None:
                break
            addr, intf, tid, frame = item
            dst = by_peer.setdefault(addr, [])
            if tid:
                # sampled frame: the trace id rides the peer hop in
                # Packet.trace_id (a proto extension reference daemons
                # skip as an unknown field) so the remote delivery
                # attaches to the same trace
                dst.append(pb.Packet(remot_intf_id=intf, frame=frame,
                                     trace_id=tid))
                traced_by_peer.setdefault(addr, []).append(
                    (len(dst) - 1, tid))
            else:
                dst.append(pb.Packet(remot_intf_id=intf, frame=frame))
        for addr, packets in by_peer.items():
            sender = self._peer_senders.get(addr)
            if sender is None:
                sender = _PeerSender(self.daemon, addr)
                self._peer_senders[addr] = sender
            sender.enqueue(packets, traced=traced_by_peer.get(addr))

    @property
    def peer_queue_dropped(self) -> int:
        """Frames dropped at per-peer sender queues (slow-peer
        backpressure), summed over peers. Snapshot via list(): the tick
        thread inserts senders on first traffic to a new peer."""
        return sum(s.dropped for s in list(self._peer_senders.values()))

    def flush_peers(self, timeout_s: float = 5.0) -> bool:
        """Block until every per-peer sender queue is empty (or timeout)
        — for tests and orderly shutdown; the data path never waits."""
        deadline = time.monotonic() + timeout_s
        for s in list(self._peer_senders.values()):
            if not s.wait_empty(max(0.0, deadline - time.monotonic())):
                return False
        return True

    # -- pending-frame persistence ------------------------------------
    #
    # In the reference, in-flight packets live in kernel qdisc queues and
    # SURVIVE a daemon restart; here the delay line is process state, so
    # these two methods make it checkpointable with the same guarantee:
    # a restored frame completes its REMAINING delay, not a fresh one.

    def export_pending(self) -> list[tuple[str, int, bytes, float]]:
        """(pod_key, uid, frame, remaining_delay_us) for every frame
        still held in the delay line, in wheel-token order per batch."""
        with self._tick_lock:
            # pipeline barrier: in-flight dispatches hold frames that are
            # not yet in _pending — they must land before export
            self.flush()
            base, origin = self.last_now_s, self._origin_s
            wheel_now = (0.0 if base is None or origin is None
                         else (base - origin) * 1e6)
            out: list[tuple[str, int, bytes, float]] = []
            for entry in self._pending.values():
                pk, uid, frames, deadlines = entry[:4]
                if type(frames) is _LazyFrames:
                    # materialize IN the entry so a later partial release
                    # and this export agree on slot identity
                    frames = entry[2] = frames.materialize()
                for i, frame in enumerate(frames):
                    if frame is not None:  # still in flight
                        out.append((pk, uid, frame,
                                    max(0.0, float(deadlines[i])
                                        - wheel_now)))
            return out

    def restore_pending(self, entries, now_s: float | None = None) -> int:
        """Schedule exported frames to release after their remaining
        delays, counted from `now_s` (default: the monotonic clock —
        pass an explicit clock when driving deterministic ticks)."""
        entries = list(entries)
        with self._tick_lock, \
                self.pauses.pause("checkpoint_load", rows=len(entries)):
            # pipeline barrier: restored entries share _pending/_bseq
            # with in-flight completions — drain them first
            self.flush()
            explicit = now_s is not None
            if now_s is None:
                if self._clock_ext:
                    # the plane runs on a synthetic clock; mixing a
                    # monotonic now with the synthetic origin would skew
                    # every restored deadline by the epoch difference
                    raise ValueError(
                        "restore_pending: plane uses an explicit clock; "
                        "pass now_s from the same clock")
                now_s = time.monotonic()
            elif (not self._clock_ext and self._origin_s is not None
                    and abs(now_s - time.monotonic()) > 10.0):
                # mirror direction: a synthetic now_s against a
                # monotonic-derived origin makes every restored deadline
                # hugely past/future due
                raise ValueError(
                    "restore_pending: plane origin is on the monotonic "
                    "clock but now_s is not; pass now_s from the same "
                    "clock")
            if self._origin_s is None:
                self._origin_s = now_s
                self.last_now_s = now_s
                self._clock_ext = explicit
            base_us = (now_s - self._origin_s) * 1e6
            for pk, uid, frame, rem_us in entries:
                deadline = base_us + rem_us
                self._bseq += 1
                # batch of one: restored frames are rare and the release
                # loop handles any batch size uniformly
                self._pending[self._bseq] = [
                    pk, uid, [bytes(frame)],
                    np.asarray([deadline], np.float64), 1]
                self._wheel.schedule(deadline, self._bseq << _TOK_BITS)
            return len(entries)

    def resume_clock(self, now_s: float, origin_s: float | None,
                     last_shaped_s: float | None) -> None:
        """Continue a checkpointed plane's EXPLICIT clock on this fresh
        plane (before its first tick or restore): the wheel keeps the
        saved origin, so every deadline and release tick is computed
        from the same clock offsets as on the saved plane, and the first
        tick rolls the restored shaping clocks by the time since the
        saved plane's last shaped tick. Values later than `now_s` are
        ignored (they are not on this clock)."""
        with self._tick_lock:
            if self._origin_s is not None or self._inflight:
                raise RuntimeError("resume_clock: the plane has ticked")
            self.last_now_s = now_s
            self._clock_ext = True
            if origin_s is not None and origin_s <= now_s:
                self._origin_s = float(origin_s)
            if last_shaped_s is not None and last_shaped_s <= now_s:
                self._last_shaped_s = float(last_shaped_s)

    # -- metrics feed --------------------------------------------------

    def counters_fn(self):
        """For metrics.make_registry(sim_counters_fn=...)."""
        return self.counters

    def _on_rows_remapped(self, old_rows, n_active: int) -> None:
        """Carry cumulative per-row counters through compact()'s row
        renumbering (new row i accumulated under old_rows[i] so far)."""
        with self._tick_lock:
            # pipeline barrier BEFORE permuting: in-flight jobs hold
            # pre-compact row indices — their counter accumulation must
            # land in the old numbering so this permutation carries it
            # (their state write-backs self-neutralize: compact marks
            # every row touched, so the merge keeps engine values)
            self.flush()
            sel = np.asarray(old_rows[:n_active], dtype=np.int64)
            cap = self.engine.state.capacity

            def permute(a):
                out = np.zeros((cap,) + a.shape[1:], a.dtype)
                # masked SCATTER: an old row beyond the counter arrays
                # contributes zero at its own new position
                keep = sel < a.shape[0]
                idx = np.nonzero(keep)[0]
                out[idx] = a[sel[keep]]
                return out

            self.counters = EdgeCounters(**{
                f.name: permute(getattr(self.counters, f.name))
                for f in dataclasses.fields(EdgeCounters)})
            if self.telemetry is not None:
                self.telemetry.remap_rows(old_rows, n_active, cap)

    # -- thread --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        if self._ff_active:
            raise RuntimeError("fast_forward in progress; start() after it "
                               "returns")
        # pipeline barrier: an explicit-clock session may have left
        # dispatches in flight — they must land before the rebase below
        self.flush()
        # Continuity when the plane last ran on a synthetic clock: rebase
        # the virtual epoch onto the monotonic clock so pending releases
        # keep their REMAINING latency and token buckets don't see a
        # decades-long "elapsed" refill on the first real tick.
        with self._tick_lock:
            if self._clock_ext and self.last_now_s is not None:
                delta = time.monotonic() - self.last_now_s
                if self._origin_s is not None:
                    self._origin_s += delta
                if self._last_shaped_s is not None:
                    self._last_shaped_s += delta
                self.last_now_s += delta
                self._clock_ext = False
        self._stop.clear()
        if not self._gc_held:
            _GCTuner.acquire()
            if self.device.type == "cpu":
                _CPUThreadCap.acquire()
            self._gc_held = True

        def loop():
            from kubedtn_tpu_torch.utils.logging import fields, get_logger

            log = get_logger("dataplane")
            period = self.dt_us / 1e6
            last_error: str | None = None
            refreeze_at: float | None = time.monotonic() + 2.0
            while not self._stop.is_set():
                t0 = time.monotonic()
                self._heartbeat_s = t0  # watchdog liveness stamp
                self._wake.clear()  # signals during the tick re-arm it
                try:
                    self.tick()
                    self._watchdog_armed = True  # warm-up tick done
                    last_error = None
                    self._safe_supervise(True)
                except Exception as e:
                    # a tick must never kill the data plane — but a
                    # persistent failure must not emit a traceback per
                    # tick either: full traceback only when the error
                    # CHANGES, a counter carries the rest
                    self.tick_errors += 1
                    self._safe_supervise(False)
                    sig = f"{type(e).__name__}: {e}"
                    if sig != last_error:
                        last_error = sig
                        log.exception("tick failed (continuing) %s",
                                      fields(tick_errors=self.tick_errors))
                now = time.monotonic()
                if refreeze_at is not None and now >= refreeze_at:
                    refreeze_at = None
                    _GCTuner.refreeze()
                # backpressure sheds the period sleep entirely: while
                # drainable ingress backlog, holdback residue, or an
                # in-flight dispatch remains, tick again immediately
                # dtnlint: lock-ok(advisory backpressure peek on the runner thread: a stale read costs at most one period sleep; tick() re-reads under the lock)
                if (self.last_backlog or self._holdback
                        or self._inflight):  # dtnlint: lock-ok(advisory peek, see above)
                    continue
                budget = period - (now - t0)
                # wake EARLY for the next scheduled release: the wheel's
                # next_due_us is a safe lower bound
                # dtnlint: lock-ok(advisory wake-early bound: _origin_s only rebases while the runner is stopped; a stale value widens the sleep by one period at most)
                if self._origin_s is not None:
                    nd = self._wheel.next_due_us()
                    if nd is not None:
                        due_in = self._origin_s + nd / 1e6 - now  # dtnlint: lock-ok(advisory bound, see above)
                        budget = min(budget, max(due_in, 0.0))
                if budget > 0:
                    # wakes early on new ingress (daemon signal) or stop
                    self._wake.wait(budget)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="wire-dataplane")
        self._thread.start()
        self._start_watchdog()

    def _start_watchdog(self) -> None:
        """Heartbeat watchdog over the runner thread: counts (and logs,
        rate-limited) loop iterations stalled beyond
        watchdog_timeout_s."""
        self._watchdog_stop.clear()

        def watchdog():
            from kubedtn_tpu_torch.utils.logging import fields, get_logger

            log = get_logger("dataplane")
            warn = fault.RateLimitedLog(min_interval_s=5.0)
            interval = max(0.05, min(1.0, self.watchdog_timeout_s / 4))
            while not self._watchdog_stop.wait(interval):
                if not self._watchdog_armed:
                    continue  # first tick still loading: warm-up
                age = self.heartbeat_age_s
                if age is not None and age > self.watchdog_timeout_s:
                    self.watchdog_stalls += 1
                    fire, suppressed = warn.ready()
                    if fire:
                        log.warning("data-plane runner stalled %s", fields(
                            heartbeat_age_s=round(age, 3),
                            stalls=self.watchdog_stalls,
                            degrade_level=self.degrade_level,
                            suppressed=suppressed))

        self._watchdog_thread = threading.Thread(
            target=watchdog, daemon=True, name="wire-dataplane-watchdog")
        self._watchdog_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()  # unblock a sleeping runner
        self._watchdog_stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=2)
            self._watchdog_thread = None
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            wedged = self._thread.is_alive()
            self._thread = None
        self._heartbeat_s = None
        if wedged:
            # the runner never exited (a dispatch wedged on the device):
            # it still holds _tick_lock inside its tick, so the flush
            # below would hang stop() forever. Skip the barrier.
            from kubedtn_tpu_torch.utils.logging import fields, get_logger

            get_logger("dataplane").error(
                "runner thread failed to stop; skipping pipeline "
                "flush %s", fields(watchdog_stalls=self.watchdog_stalls))
        else:
            # pipeline barrier: the runner may have exited with
            # dispatches still in flight — their frames must land in the
            # delay line (and their counters accumulate)
            self.flush()
        if self._gc_held:
            self._gc_held = False
            _GCTuner.release()
            if self.device.type == "cpu":
                _CPUThreadCap.release()
        # senders are one-shot threads: drop them so a stop()/start()
        # restart creates fresh ones instead of enqueueing into queues
        # whose consumer has exited (silent cross-node black hole).
        # Signal ALL senders first, then join against one shared
        # deadline — N wedged peers cost one timeout, not N.
        senders, self._peer_senders = self._peer_senders, {}
        for sender in senders.values():
            sender.request_stop()
        deadline = time.monotonic() + 5.0
        for sender in senders.values():
            sender.join(deadline)
