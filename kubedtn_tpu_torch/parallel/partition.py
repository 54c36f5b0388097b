"""Edge partitioner of the sharded live tick: block sharding along the
edge axis.

Port of kubedtn_tpu/parallel/partition.py's `shard_ranges`,
`shard_of_rows`, `pick_pair_rows`, `tenant_blocks` / `tenant_block` and
`colocation_stats`. Shard s owns the contiguous row range
[s*E/S, (s+1)*E/S). A row is CROSS-SHARD for a tick when the shard that
owns it is not the shard that shapes its peer direction; its state rides
the mailbox ring (parallel/exchange.py) to every shard.
"""

from __future__ import annotations

import numpy as np


def shard_ranges(capacity: int, n_shards: int) -> list[tuple[int, int]]:
    """[(lo, hi)) row range per shard. Requires capacity % n_shards == 0."""
    if n_shards <= 0 or capacity % n_shards:
        raise ValueError(
            f"capacity {capacity} not divisible by {n_shards} shards")
    loc = capacity // n_shards
    return [(s * loc, (s + 1) * loc) for s in range(n_shards)]


def shard_of_rows(rows, capacity: int, n_shards: int) -> np.ndarray:
    """Owner shard per row (block sharding)."""
    loc = capacity // n_shards
    return np.asarray(rows, np.int64) // loc


def pick_pair_rows(free, capacity: int, n_shards: int,
                   scan_limit: int = 64) -> tuple[int, int]:
    """Pop TWO free rows colocated in one shard block where possible.

    `free` is the engine's free-list stack (topology/freelist.FreeStack;
    pop from the top). The first row pops normally; the second is the
    nearest free row to the top, within a `scan_limit`-entry window, in
    the SAME block, falling back to a plain pop when the block has no
    other free row in reach."""
    r1 = free.pop()
    if n_shards <= 1:
        return r1, free.pop()
    loc = capacity // n_shards
    blk = r1 // loc
    window = free.top_view(scan_limit)
    hits = np.nonzero(window // loc == blk)[0]
    if hits.size:
        i = len(free) - window.shape[0] + int(hits[-1])
        return r1, free.pop_at(i)
    return r1, free.pop()



def tenant_blocks(free, capacity: int, n_shards: int,
                  requests: list[int]) -> list[tuple[int, int] | None]:
    """Carve a CONTIGUOUS run of currently free rows out of the engine's
    free list for EACH requested tenant edge block, in ONE sorted pass
    (the batch behind `tenant_block` and the registry's re-carve after a
    compact).

    Composition with shard blocks: for each request, a run that fits
    entirely inside one shard's [s*E/S, (s+1)*E/S) range is preferred (a
    tenant whose block sits inside one shard never pays the cross-shard
    mailbox for intra-tenant hops), falling back to a boundary-spanning
    run only when no shard-local run is free. Requests are served in
    order; returns a same-length list of [lo, hi) (rows removed from
    `free`) or None where no contiguous run of that length exists."""
    loc = (capacity // n_shards
           if n_shards > 1 and capacity % n_shards == 0 else capacity)
    rows = np.sort(np.asarray(
        free.view() if hasattr(free, "view") else free, np.int64))
    # maximal contiguous runs as half-open [lo, hi), split as windows
    # are carved out of them
    runs: list[tuple[int, int]] = []
    if rows.size:
        breaks = np.nonzero(np.diff(rows) != 1)[0] + 1
        starts = [0, *breaks.tolist(), rows.size]
        runs = [(int(rows[a]), int(rows[b - 1]) + 1)
                for a, b in zip(starts[:-1], starts[1:])]
    out: list[tuple[int, int] | None] = []
    carved: list[tuple[int, int]] = []
    for n_rows in requests:
        if n_rows <= 0:
            out.append(None)
            continue
        local: tuple[int, int, int] | None = None
        spanning: tuple[int, int, int] | None = None
        for idx, (lo, hi) in enumerate(runs):
            if hi - lo < n_rows:
                continue
            if spanning is None:
                spanning = (idx, lo, lo + n_rows)
            # the earliest window of the run that does not straddle a
            # shard boundary: `lo` itself or the next boundary
            if n_rows <= loc:
                w_lo = (lo if lo // loc == (lo + n_rows - 1) // loc
                        else (lo // loc + 1) * loc)
                if w_lo + n_rows <= hi:
                    local = (idx, w_lo, w_lo + n_rows)
                    break
        best = local if local is not None else spanning
        if best is None:
            out.append(None)
            continue
        idx, lo, hi = best
        rlo, rhi = runs[idx]
        runs[idx:idx + 1] = [r for r in ((rlo, lo), (hi, rhi))
                             if r[1] > r[0]]
        carved.append((lo, hi))
        out.append((lo, hi))
    if carved:
        # one order-preserving filter of the free stack
        taken = np.concatenate(
            [np.arange(lo, hi, dtype=np.int64) for lo, hi in carved])
        if hasattr(free, "remove_rows"):
            free.remove_rows(taken)
        else:  # a plain list
            tset = set(taken.tolist())
            free[:] = [r for r in free if r not in tset]
    return out


def tenant_block(free, capacity: int, n_shards: int,
                 n_rows: int) -> tuple[int, int] | None:
    """Single-request form of `tenant_blocks` (same preference order
    and free-list contract)."""
    return tenant_blocks(free, capacity, n_shards, [n_rows])[0]


def colocation_stats(engine, n_shards: int) -> dict:
    """Partition quality of the engine's current topology: per-shard
    active edge counts, load imbalance (max/mean - 1), and the fraction
    of peered links whose two directed rows share a shard (the frames
    that never ride the ring exchange)."""
    with engine._lock:
        engine._flush_device_locked()
        state = engine._state
        peer = dict(engine._peer)
        rows = dict(engine._rows)
    E = state.capacity
    if E % n_shards:
        raise ValueError(f"capacity {E} not divisible by {n_shards}")
    active = state.active.cpu().numpy()
    per_shard = active.reshape(n_shards, E // n_shards).sum(axis=1)
    total = int(per_shard.sum())
    mean = total / n_shards
    imbalance = (float(per_shard.max()) / mean - 1.0) if total else 0.0
    loc = E // n_shards
    pairs = colocated = 0
    for k, pk in peer.items():
        if k > pk:
            continue  # count each link once
        r1, r2 = rows.get(k), rows.get(pk)
        if r1 is None or r2 is None:
            continue
        pairs += 1
        if r1 // loc == r2 // loc:
            colocated += 1
    return {
        "n_shards": int(n_shards),
        "edges_per_shard": [int(x) for x in per_shard],
        "total_edges": total,
        "imbalance": round(imbalance, 4),
        "links_paired": pairs,
        "links_colocated": colocated,
        "colocated_frac": round(colocated / pairs, 4) if pairs else 1.0,
    }
