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

The host plane that drives this program (WireDataPlane's drain, holdback
and depth-N pipeline, the TBF fallback re-shape at completion, the
telemetry window ring, the gRPC server) comes in a later slice.

THE TICK KEY is two uint32 words (Python ints, so splitting it never
touches the device). `split(key)` is one Philox4x32-10 call under `key`
on the counter (0, 0, 0, 2^32 - 1): words 0-1 are the next tick key,
words 2-3 the tick's sub-key. The row cores' draws use counters whose
last word is class*2 + block <= 5, so the split's counter never collides
with a draw's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch import telemetry as tele
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.cuda import philox
from kubedtn_tpu_torch.ops.edge_state import NCORR, NPROP

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
    the CUDA card). `batches[i]` holds the row at [1] and the frame
    lengths at [2] (the data plane's (wire, row, lens, frames, decided)
    tuples); `group` lists the batch indices of the class. Padding rows
    carry index E; key_ids holds each row's 64-bit key id from
    `keyid_map` as its two uint32 words (0 on padding rows)."""
    dev = resolve_device(device)
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
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (row_idx, sizes, valid, key_ids))


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
