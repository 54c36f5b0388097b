"""Routing: reachability, all-pairs shortest paths, next hops.

Port of kubedtn_tpu/ops/routing.py. The reference has no routing of its
own — pods run real routing daemons over the emulated links. Here the
network's control plane is simulated too: when a link goes up or down,
routes are recomputed on the device.

- `reachability`: boolean transitive closure via log2(n) dense matmuls
  (f32 matmul + threshold).
- `all_pairs_dist`: min-plus Bellman-Ford relaxation over the edge list
  with a segment-min keyed on edge sources; destinations processed in
  static chunks so the [E, chunk] candidate tensor stays bounded;
  iterated a fixed `max_hops` (diameter bound).
- `next_hop_edges`: per (node, destination) the egress edge row realizing
  the shortest path, extracted with a tie-broken segment-min.
- `ecmp_next_hop_edges`: up to K tied egress rows per (node,
  destination); the router hashes flows across the group (router.py).
- `update_routes_incremental`: delta reconvergence after a link event.

Weights are µs latencies by default (the shaping latency column), so
paths minimize propagation delay, and unreachable pairs are +inf.

The JAX package scans and while-loops inside jit; here the relaxations
are Python loops, and a fixpoint reads one `.any()` per sweep. A JAX
gather clamps an out-of-range index and a scatter drops it: `_take`
clamps, and every segment-min has one extra row that is cut off. Min is
exact in any order, so the atomics of the card's scatter change nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kubedtn_tpu_torch.ops.edge_state import EdgeState, P_LATENCY_US

F32, I32 = torch.float32, torch.int32
INF = float("inf")


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """x.index_select(dim, idx) with JAX's gather rule: a negative index
    counts from the end, an out-of-range one is clamped."""
    n = x.shape[dim]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x.index_select(dim, idx)


def _segment_min(cand: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """out[s] = min over rows e with seg[e] == s of cand[e] (+inf for an
    empty segment). `seg` is int64 in [0, n_seg]; row n_seg is the drop
    segment and is cut off."""
    out = torch.full((n_seg + 1,) + tuple(cand.shape[1:]), INF,
                     dtype=cand.dtype, device=cand.device)
    index = seg.reshape((-1,) + (1,) * (cand.dim() - 1)).expand_as(cand)
    out.scatter_reduce_(0, index, cand, "amin", include_self=True)
    return out[:n_seg]


def _graph(state: EdgeState, n_nodes: int, reverse: bool = False):
    """(src, dstv): each row's source segment (n_nodes = drop for an
    inactive row) and the node whose distances it reads (0 for an
    inactive row), int64."""
    a, b = (state.dst, state.src) if reverse else (state.src, state.dst)
    return (torch.where(state.active, a, n_nodes).long(),
            torch.where(state.active, b, 0).long())


def adjacency(state: EdgeState, n_nodes: int) -> torch.Tensor:
    """0/1 adjacency f32[n, n] from active directed edges."""
    a = torch.zeros((n_nodes + 1, n_nodes), dtype=F32, device=state.device)
    src, _ = _graph(state, n_nodes)
    # inactive rows write the cut-off row; every write is the same 1.0
    a[src, state.dst.long().clamp(0, n_nodes - 1)] = 1.0
    return a[:n_nodes]


def reachability(state: EdgeState, n_nodes: int) -> torch.Tensor:
    """Transitive closure: reach[i, j] = True if j reachable from i (i→i
    always). log2(n) squarings of the adjacency. The operands are 0/1
    and every dot product a count below 2^24: exact in f32, and in TF32
    too, whose 10-bit mantissa holds 0 and 1 exactly and whose
    accumulator is f32."""
    a = adjacency(state, n_nodes)
    r = torch.clamp_max(a + torch.eye(n_nodes, dtype=F32,
                                      device=state.device), 1.0)
    n_iters = max(1, math.ceil(math.log2(max(n_nodes, 2))))
    for _ in range(n_iters):
        r = torch.clamp_max(r @ r, 1.0)
    return r > 0.5


def edge_weights_latency(state: EdgeState) -> torch.Tensor:
    """Default routing metric: configured latency (µs) + 1 so zero-latency
    links still cost a hop (shortest-path = fewest hops among equal
    latencies); inactive edges are +inf."""
    return torch.where(state.active, state.props[:, P_LATENCY_US] + 1.0,
                       INF)


def _chunking(n_nodes: int, dst_chunk: int | None) -> tuple[int, int]:
    """(chunk width, number of chunks) of the destination axis."""
    if dst_chunk is None or dst_chunk >= n_nodes:
        return n_nodes, 1
    if n_nodes % dst_chunk:
        raise ValueError(f"dst_chunk {dst_chunk} must divide n_nodes "
                         f"{n_nodes}")
    return dst_chunk, n_nodes // dst_chunk


def _by_chunks(fn, mat: torch.Tensor, n_nodes: int,
               dst_chunk: int | None) -> torch.Tensor:
    """fn over each block of destination columns of `mat` [n, n]; the
    blocks are independent. fn may add trailing axes."""
    width, n_chunks = _chunking(n_nodes, dst_chunk)
    if n_chunks == 1:
        return fn(mat)
    return torch.cat([fn(mat[:, c * width:(c + 1) * width])
                      for c in range(n_chunks)], dim=1)


def _relax(weights, src, dstv, n_nodes: int, d: torch.Tensor):
    """One min-plus sweep of a [n, B] column block."""
    cand = weights[:, None] + d.index_select(0, dstv)          # [E, B]
    return torch.minimum(d, _segment_min(cand, src, n_nodes))


def _diag_zero(mat: torch.Tensor) -> torch.Tensor:
    out = mat.clone()
    out.fill_diagonal_(0.0)
    return out


def all_pairs_dist(state: EdgeState, weights: torch.Tensor, nodes,
                   n_nodes: int, max_hops: int = 16,
                   dst_chunk: int | None = None) -> torch.Tensor:
    """All-pairs shortest-path distances, min-plus relaxation.

    dist[i, j] = cost of the cheapest directed path i→j (0 on the
    diagonal, +inf when unreachable). `max_hops` bounds path length
    (diameter).

    The relaxation D'[u, j] = min(D[u, j], min over edges u→v of
    w_uv + D[v, j]) is computed for all destinations in chunks: the
    [E, chunk] candidate matrix is reduced into [n, chunk] with a
    segment-min keyed on edge sources."""
    del nodes  # reserved for subset-destination variants
    src, dstv = _graph(state, n_nodes)
    d0 = _diag_zero(torch.full((n_nodes, n_nodes), INF, dtype=F32,
                               device=state.device))

    def relax_chunk(d):
        for _ in range(max_hops):
            d = _relax(weights, src, dstv, n_nodes, d)
        return d

    return _by_chunks(relax_chunk, d0, n_nodes, dst_chunk)


def next_hop_edges(state: EdgeState, dist: torch.Tensor, n_nodes: int,
                   dst_chunk: int | None = None) -> torch.Tensor:
    """next_edge[u, j]: edge row of u's best egress toward destination j
    (-1 when unreachable or u == j). Ties break to the lowest edge row.
    The single-path (k_paths=1) slice of ecmp_next_hop_edges."""
    return ecmp_next_hop_edges(state, dist, n_nodes, 1, dst_chunk)[:, :, 0]


def _rows_to_int(nh: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(nh), nh, -1.0).to(I32)


def ecmp_next_hop_edges(state: EdgeState, dist: torch.Tensor, n_nodes: int,
                        k_paths: int = 4,
                        dst_chunk: int | None = None) -> torch.Tensor:
    """ECMP next hops: nh[u, j, :] = up to `k_paths` edge rows of u's
    equal-cost egresses toward j (-1 padded), lowest rows first.
    k_paths passes of tie-broken segment-min with exclusion."""
    E = state.capacity
    weights = edge_weights_latency(state)
    src, dstv = _graph(state, n_nodes)
    rows = torch.arange(E, dtype=F32, device=state.device)[:, None]
    # the reference reads best[state.src] and nh[state.src], unmasked:
    # an inactive row reads its stale source's cells and lands on the
    # drop segment all the same
    own = state.src

    def chunk_fn(d_chunk):
        cand = weights[:, None] + d_chunk.index_select(0, dstv)
        best = _segment_min(cand, src, n_nodes)
        avail = cand <= _take(best, own) + 1e-3        # tied best edges
        picks = []
        for _ in range(k_paths):
            nh = _segment_min(torch.where(avail, rows, INF), src, n_nodes)
            picks.append(nh)
            avail = avail & (rows != _take(nh, own))    # exclude chosen
        return _rows_to_int(torch.stack(picks, dim=-1))  # [n, chunk, K]

    nh = _by_chunks(chunk_fn, dist, n_nodes, dst_chunk)
    # only keep hops for reachable, non-self destinations
    ok = torch.isfinite(dist) & (dist > 0.0)
    return torch.where(ok[:, :, None], nh, -1)


def recompute_routes_ecmp(state: EdgeState, n_nodes: int, k_paths: int = 4,
                          max_hops: int = 16,
                          dst_chunk: int | None = None):
    """recompute_routes with an ECMP table: (dist, nh[n, n, k_paths])."""
    w = edge_weights_latency(state)
    dist = all_pairs_dist(state, w, None, n_nodes, max_hops, dst_chunk)
    nh = ecmp_next_hop_edges(state, dist, n_nodes, k_paths, dst_chunk)
    return dist, nh


def recompute_routes(state: EdgeState, n_nodes: int, max_hops: int = 16,
                     dst_chunk: int | None = None):
    """The link-event route recompute: distances + next hops in one call
    — what runs after AddLinks/DelLinks/UpdateLinks change the topology,
    as one batched device computation instead of per-router protocol
    exchange."""
    w = edge_weights_latency(state)
    dist = all_pairs_dist(state, w, None, n_nodes, max_hops, dst_chunk)
    nh = next_hop_edges(state, dist, n_nodes, dst_chunk)
    return dist, nh


# -- incremental reconvergence ----------------------------------------
#
# A link flap changes a handful of edge rows; recomputing all-pairs from
# scratch re-relaxes max_hops times over every destination. The delta
# path below re-derives only what the event can have changed, seeded
# from the previous distance matrix. ALL changed edges of one event are
# processed in ONE batch: one fused detection pass, at most one dense
# improvement pass, and one restricted fixpoint on the union affected
# set.
#
# - weight INCREASES (links down / slower): a pair is invalidated iff
#   some OLD shortest path crossed some increased edge. The per-edge
#   crossing test dist[u,j] == dist[u,s]+w_old+dist[d,j] is exact
#   against the pre-event matrix, and simultaneous increases compose.
#   Detection never pays an [n, n] pass: the row and column projections
#   of each edge's flagged set have exact O(n) witnesses
#   (_per_edge_up_flags), and the precise pair mask is only computed on
#   the gathered block a fixpoint will rebuild.
# - weight DECREASES (links up / faster): improved pairs route through
#   at least one decreased edge. Decompose any new shortest path at its
#   FIRST decreased edge e: the prefix uses no decreased edge and the
#   suffix cost is the exact NEW distance from e's head. So: first
#   compute exact new distances TO every decreased-edge source (a
#   column-block fixpoint) and FROM every decreased-edge head (the same
#   fixpoint on the reversed graph), then apply
#     dist'[u,j] = min(seed[u,j], min_e Dc[u,s_e]+w_new_e+Dr[d_e,j])
#   — a rank-k min-plus product, exact for every improved pair in one
#   shot, restricted to grouped candidate blocks (_improve_candidates).
#
# After the improvement products, only increase-invalidated pairs can
# still be stale; restricted fixpoints on the affected sets (column
# block, row block, grouped col+row, or dense — cheapest projections
# win) finish. Pure-decrease events skip the fixpoint entirely. The
# fixpoints stop the moment nothing changes, capped at max_hops.


def _fix_loop(weights, src, dstv, n_nodes: int, max_hops: int,
              d_block: torch.Tensor) -> torch.Tensor:
    """THE min-plus relaxation fixpoint on a [n, B] column block — the
    single implementation behind refine_dist (full matrix, in chunks)
    and _fix_block (gathered affected columns); columns are independent
    under the relaxation, so any subset converges alone. One host read
    per sweep."""
    d = d_block
    for _ in range(max_hops):
        d2 = _relax(weights, src, dstv, n_nodes, d)
        changed = bool((d2 < d).any())
        d = d2
        if not changed:
            break
    return d


def refine_dist(state: EdgeState, n_nodes: int, seed_dist: torch.Tensor,
                max_hops: int = 16,
                dst_chunk: int | None = None) -> torch.Tensor:
    """Min-plus fixpoint from a seed matrix whose finite entries are
    valid upper bounds (and whose unknown entries are +inf). Converges
    to the same result as all_pairs_dist but stops the moment nothing
    changes — the work is proportional to how far the event's effects
    reach, not to the diameter bound."""
    weights = edge_weights_latency(state)
    src, dstv = _graph(state, n_nodes)

    def fix_chunk(d):
        return _fix_loop(weights, src, dstv, n_nodes, max_hops, d)

    return _by_chunks(fix_chunk, _diag_zero(seed_dist), n_nodes, dst_chunk)


def _fix_block(state: EdgeState, n_nodes: int, d_block: torch.Tensor,
               max_hops: int, reverse: bool = False) -> torch.Tensor:
    """Min-plus fixpoint on a gathered [n, B] column block. With
    `reverse`, on the REVERSED graph: column j of the result is then the
    exact distance FROM node j (dist rows, transposed) — used to get
    exact new distances from every decreased-edge head."""
    src, dstv = _graph(state, n_nodes, reverse)
    return _fix_loop(edge_weights_latency(state), src, dstv, n_nodes,
                     max_hops, d_block)


def _nh_block(state: EdgeState, n_nodes: int,
              dist_block: torch.Tensor) -> torch.Tensor:
    """Single-path next hops for an arbitrary [n, B] block of
    destination columns — the k=1 case of ecmp_next_hop_edges' chunk on
    gathered (non-contiguous) columns, same tie tolerance (1e-3) and
    drop-row convention."""
    E = state.capacity
    weights = edge_weights_latency(state)
    src, dstv = _graph(state, n_nodes)
    rows = torch.arange(E, dtype=F32, device=state.device)[:, None]
    cand = weights[:, None] + dist_block.index_select(0, dstv)
    best = _segment_min(cand, src, n_nodes)
    avail = cand <= _take(best, state.src) + 1e-3
    nh = _rows_to_int(_segment_min(torch.where(avail, rows, INF), src,
                                   n_nodes))
    ok = torch.isfinite(dist_block) & (dist_block > 0.0)
    return torch.where(ok, nh, -1)


def _minplus_outer(a_cols: torch.Tensor, w: torch.Tensor,
                   b_rows: torch.Tensor) -> torch.Tensor:
    """min over e of a_cols[:, e] + w[e] + b_rows[e, :] — the rank-k
    min-plus outer product behind batched detection and improvement.
    Entries padded with w=+inf are inert."""
    out = a_cols[:, 0:1] + w[0] + b_rows[0:1, :]
    for e in range(1, a_cols.shape[1]):
        out = torch.minimum(out, a_cols[:, e:e + 1] + w[e]
                            + b_rows[e:e + 1, :])
    return out


# The pair-level crossing test for increased edge e=(s,d,w),
# dist[u,j] == dist[u,s]+w+dist[d,j], projects to rows/columns with
# exact O(n) WITNESSES: u has some flagged j iff j=d itself is flagged
# (the suffix of any crossing shortest path is a crossing path to d),
# so rows_e = {u : dist[u,s]+w <= dist[u,d]+eps} — two gathered
# columns, no [n, n] pass. Symmetrically cols_e = {j : w+dist[d,j] <=
# dist[s,j]+eps} from two gathered rows.


def _crossed(d: torch.Tensor, via: torch.Tensor) -> torch.Tensor:
    """Pairs of `d` whose old shortest path `via` an increased edge is
    as short as the old distance (within the pair-level eps)."""
    eps = 1e-2 + 1e-5 * torch.abs(d)
    return torch.isfinite(d) & (via <= d + eps)


def _up_inval_rows(old_dist, rows_idx, s, d, wo) -> torch.Tensor:
    """Union increase-invalidation mask gathered to a row block [B, n]."""
    du = _take(old_dist, rows_idx)                              # [B, n]
    return _crossed(du, _minplus_outer(_take(du, s, 1), wo,
                                       _take(old_dist, d)))


def _up_inval_cols(old_dist, cols_idx, s, d, wo) -> torch.Tensor:
    """Union increase-invalidation mask gathered to a column block
    [n, B]."""
    dj = _take(old_dist, cols_idx, 1)                           # [n, B]
    return _crossed(dj, _minplus_outer(
        _take(old_dist, s, 1), wo, _take(_take(old_dist, d), cols_idx, 1)))


def _apply_up_inval_dense(dist, s, d, wo):
    """Invalidate (set +inf) every pair whose old shortest path crossed
    an increased edge — dense. Also returns the hit projections
    (cols[n], rows[n]): the pair-level eps (scaled by |dist[u,j]|) is
    slightly WIDER than the witness eps (scaled by the endpoint
    distances), so callers that won't rebuild this very matrix densely
    must add these projections to their rebuild sets or a near-crossing
    pair could stay +inf."""
    hit = _crossed(dist, _minplus_outer(_take(dist, s, 1), wo,
                                        _take(dist, d)))
    return (torch.where(hit, INF, dist), hit.any(dim=0), hit.any(dim=1))


def _improve_block(seed, a, wn, b):
    """Decrease application on an arbitrary [R, C] block: block' =
    min(seed, rank-k min-plus product a[R, k] ⊗ wn ⊗ b[k, C]). Returns
    (block', changed_over_rows[C], changed_over_cols[R]) — the ACTUAL
    improved set. `seed` may contain +inf invalidation holes; a hole
    whose new path crosses a decreased edge is rebuilt right here (this
    is also how a link-up reconnects a partition)."""
    d1 = torch.minimum(seed, _minplus_outer(a, wn, b))
    chg = d1 < seed
    return d1, chg.any(dim=0), chg.any(dim=1)


def _improve_candidates(old_dist, a_full, wn, b_full, s, d):
    """PER-EDGE candidate improved rows/cols for a decrease batch,
    O(n·k): a pair (u, j) can only improve through decreased edge e if
    u's cost VIA e to e's head beats (or ties) its old distance there —
    Dc[u,s_e]+wn_e <= old[u,d_e]+eps — and symmetrically for columns.
    Conservative superset: ties are kept so composed improvements are
    never missed. Returns (u_mask[n, k], v_mask[k, n])."""
    col_d = _take(old_dist, d, 1)                # [n, k]
    via_u = a_full + wn[None, :]
    eps_d = 1e-2 + 1e-5 * torch.abs(col_d)
    u_mask = torch.isfinite(via_u) & (via_u <= col_d + eps_d)
    row_s = _take(old_dist, s)                   # [k, n]
    via_v = wn[:, None] + b_full
    eps_s = 1e-2 + 1e-5 * torch.abs(row_s)
    v_mask = torch.isfinite(via_v) & (via_v <= row_s + eps_s)
    return u_mask, v_mask


def _per_edge_up_flags(old_dist, s, d, wo):
    """Per-increased-edge affected projections via the exact witnesses:
    (cols[k, n], rows[k, n]) from four gathered vectors per edge —
    O(n·k) total. Entries padded with wo=+inf are inert."""
    col_s = _take(old_dist, s, 1)                # [n, k]
    col_d = _take(old_dist, d, 1)                # [n, k]
    eps_d = 1e-2 + 1e-5 * torch.abs(col_d)
    rows = torch.isfinite(col_d) & (col_s + wo[None, :] <= col_d + eps_d)
    row_s = _take(old_dist, s)                   # [k, n]
    row_d = _take(old_dist, d)                   # [k, n]
    eps_s = 1e-2 + 1e-5 * torch.abs(row_s)
    cols = torch.isfinite(row_s) & (wo[:, None] + row_d <= row_s + eps_s)
    return cols, rows.T


def _rows_block_edges(state: EdgeState, row_map, sel_edges):
    """(w_sel, src_blk, dst_sel, dst_blk) of the selected edge rows
    `sel_edges` (padded with E, whose weight is +inf): their weights,
    their sources' block indices, their heads and the heads' block
    indices (B for a head outside the block)."""
    weights = edge_weights_latency(state)
    w_sel = torch.where(sel_edges < state.capacity,
                        _take(weights, sel_edges), INF)
    src_blk = _take(row_map, _take(state.src, sel_edges)).long()
    dst_sel = _take(state.dst, sel_edges)
    return w_sel, src_blk, dst_sel, _take(row_map, dst_sel).long()


def _with_inf_row(d: torch.Tensor) -> torch.Tensor:
    return torch.cat([d, torch.full((1, d.shape[1]), INF, dtype=d.dtype,
                                    device=d.device)], dim=0)


def _fix_rows_block(state: EdgeState, dist, seed_rows, rows_idx, row_map,
                    sel_edges, max_hops: int = 64):
    """Min-plus fixpoint restricted to a gathered block of SOURCE rows.

    The dual of the column restriction: when an event invalidates few
    rows across many destination columns (a stub uplink: every pair
    FROM one leaf), relaxing only those rows converges against the
    fixed remainder of the matrix. d[u, j] = min over edges u→v of
    w + d[v, j]: contributions from unaffected v are constant and fold
    into a one-time bound; only edges between affected rows stay in the
    loop.

    dist: the pre-event matrix — correct for every FIXED (non-block)
      row, which is all this function reads from it.
    seed_rows: f32[B, n] block rows with invalidation applied.
    rows_idx: int[B] affected rows (padded with n_nodes).
    row_map: int[n+1] node → block index (B for non-block nodes).
    sel_edges: int[Eb] edge rows whose src is in the block (padded E)."""
    B = rows_idx.shape[0]
    w_sel, src_blk, dst_sel, dst_blk = _rows_block_edges(state, row_map,
                                                         sel_edges)
    dyn = dst_blk < B                                # dst is a block row
    w_fixed = torch.where(dyn, INF, w_sel)
    w_dyn = torch.where(dyn, w_sel, INF)

    # one-time bound via FIXED rows (their dist values are final)
    cand_fixed = w_fixed[:, None] + _take(dist, dst_sel)
    d = torch.minimum(seed_rows, _segment_min(cand_fixed, src_blk, B))
    for _ in range(max_hops):
        cand = w_dyn[:, None] + _with_inf_row(d).index_select(0, dst_blk)
        d2 = torch.minimum(d, _segment_min(cand, src_blk, B))
        changed = bool((d2 < d).any())
        d = d2
        if not changed:
            break
    return d


def _nh_rows_block(state: EdgeState, dist, d_rows, rows_idx, row_map,
                   sel_edges) -> torch.Tensor:
    """Single-path next hops for a gathered block of source rows.
    Destination reads select between the refreshed block rows and the
    (final) full-matrix rows without materializing an updated copy."""
    B = rows_idx.shape[0]
    w_sel, src_blk, dst_sel, dst_blk = _rows_block_edges(state, row_map,
                                                         sel_edges)
    in_blk = (dst_blk < B)[:, None]
    dist_dst = torch.where(in_blk,
                           _with_inf_row(d_rows).index_select(0, dst_blk),
                           _take(dist, dst_sel))                # [Eb, n]
    cand = w_sel[:, None] + dist_dst
    best = _segment_min(cand, src_blk, B)
    avail = cand <= _take(best, src_blk) + 1e-3
    erows = torch.where(avail, sel_edges[:, None].to(F32), INF)
    nh = _rows_to_int(_segment_min(erows, src_blk, B))
    ok = torch.isfinite(d_rows) & (d_rows > 0.0)
    return torch.where(ok, nh, -1)


def _scatter_cols(mat: torch.Tensor, cols: torch.Tensor,
                  block: torch.Tensor) -> torch.Tensor:
    """Column-block write-back, in place. Padding repeats a column with
    the same values, so whichever copy lands last writes the same."""
    mat.index_copy_(1, cols.long(), block)
    return mat


def _scatter_rows(mat: torch.Tensor, rows: torch.Tensor,
                  block: torch.Tensor) -> torch.Tensor:
    """Row-block write-back, in place (a repeated row carries the same
    values in each copy)."""
    mat.index_copy_(0, rows.long(), block)
    return mat


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def update_routes_incremental(state: EdgeState, n_nodes: int,
                              old_dist: torch.Tensor, old_nh: torch.Tensor,
                              changed_src, changed_dst, old_w, new_w,
                              max_hops: int = 64,
                              dst_chunk: int | None = None):
    """Delta reconvergence after a link event — the incremental
    counterpart of a (converged) recompute_routes.

    The event is described by its changed DIRECTED edge rows:
    changed_src/changed_dst plus old_w/new_w, the edge weights before
    and after as edge_weights_latency would produce them (latency_us+1;
    +inf for a deleted/down edge — pass the DOWN direction with
    new_w=inf and the UP direction with old_w=inf), as host arrays.

    ALL edges of the event are processed as ONE batch (see the section
    comment above for the exactness argument): O(n·k) witness-based
    per-edge detection for the increases, exact endpoint-block fixpoints
    plus grouped rank-k min-plus products for the decreases, then
    restricted fixpoints on the affected sets, picking the cheapest
    projections by estimated relaxation cost:

    - column block (cost ≈ E × B_cols per sweep): a transit link — many
      sources, few destinations behind it;
    - row block (cost ≈ E_block × n per sweep): a stub uplink — one
      source, every destination;
    - GROUPED col pass + row pass: a link's two directions (and a
      restored link's improvement set) form a CROSS — narrow in each
      projection separately, dense as a union;
    - both wide per edge: dense seeded fixpoint over the full matrix.

    Pure-decrease events (links up) skip the fixpoint: the grouped
    products are already exact everywhere.

    Returns (dist, nh, cells): new tensors (the inputs are not
    modified); `cells` counts matrix cells re-derived — fixpoint block
    areas plus product block areas. Tie caveat: where an event creates a
    NEW equal-cost alternative without changing a distance, untouched
    entries keep their previous (still shortest) next hop, which may
    differ from a cold recompute's lowest-row tie-break. max_hops caps
    fixpoint ITERATIONS, not path length."""
    dev = state.device

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    def host(x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy()

    src_np = np.asarray(changed_src).astype(np.int64)
    dst_np = np.asarray(changed_dst).astype(np.int64)
    wo_np = np.asarray(old_w, np.float32)
    wn_np = np.asarray(new_w, np.float32)
    # drop no-op rows (unchanged weight, including inf→inf)
    keep = wo_np != wn_np
    src_np, dst_np = src_np[keep], dst_np[keep]
    wo_np, wn_np = wo_np[keep], wn_np[keep]
    dist = old_dist.clone()
    nh = old_nh.clone()
    if len(src_np) == 0:
        return dist, nh, 0
    up = wn_np > wo_np
    dn = ~up
    cells = 0
    E = state.capacity

    def padded(values, k_pad: int, fill, dtype):
        """`values` padded with `fill` to k_pad entries, on the device."""
        out = np.full(k_pad, fill, dtype=np.asarray(values).dtype)
        out[:len(values)] = values
        return on_dev(out, dtype)

    def index_block(sel: np.ndarray, fill=None):
        """The selected node indices padded to a power of two (with the
        first of them, or `fill`), on the device."""
        return padded(sel, _pow2(len(sel)),
                      sel[0] if fill is None else fill, I32)

    # Per-edge flags are the default detection: a link-down's two
    # directions flood OPPOSITE projections (one touches few rows
    # across many columns, the other few columns across many rows), so
    # the UNION is wide in both axes while each edge alone is narrow —
    # grouping by per-edge preference keeps blocks small.
    pcK = prK = None
    if up.any():
        ku = int(up.sum())
        kp = _pow2(ku)
        s_u = padded(src_np[up], kp, 0, I32)
        d_u = padded(dst_np[up], kp, 0, I32)
        wo_u = padded(wo_np[up], kp, np.inf, F32)
        pc, pr = _per_edge_up_flags(dist, s_u, d_u, wo_u)
        pcK = host(pc)[:ku]
        prK = host(pr)[:ku]
        colU = pcK.any(axis=0)
        rowU = prK.any(axis=0)
    else:
        colU = np.zeros(n_nodes, bool)
        rowU = np.zeros(n_nodes, bool)

    if dn.any():
        # exact new distances TO decreased-edge sources (column block)
        # and FROM decreased-edge heads (reverse-graph column block),
        # seeded with increase invalidation applied
        S_nodes = np.unique(src_np[dn])
        D_nodes = np.unique(dst_np[dn])
        S_pad, D_pad = index_block(S_nodes), index_block(D_nodes)
        seed_S = _take(dist, S_pad, 1)
        seed_R = _take(dist, D_pad)
        if up.any():
            seed_S = torch.where(
                _up_inval_cols(dist, S_pad, s_u, d_u, wo_u), INF, seed_S)
            seed_R = torch.where(
                _up_inval_rows(dist, D_pad, s_u, d_u, wo_u), INF, seed_R)
        Dc = _fix_block(state, n_nodes, seed_S, max_hops)     # [n, Bs]
        Dr = _fix_block(state, n_nodes, seed_R.T.contiguous(), max_hops,
                        reverse=True).T
        # per-decreased-edge gathers into the rank-k product operands
        kd = int(dn.sum())
        kp = _pow2(kd)
        a_idx = padded(np.searchsorted(S_nodes, src_np[dn]), kp, 0, I32)
        b_idx = padded(np.searchsorted(D_nodes, dst_np[dn]), kp, 0, I32)
        wn_d = padded(wn_np[dn], kp, np.inf, F32)
        s_dn = padded(src_np[dn], kp, 0, I32)
        d_dn = padded(dst_np[dn], kp, 0, I32)
        A_full = _take(Dc, a_idx, 1)                          # [n, kp]
        B_full = _take(Dr, b_idx)                             # [kp, n]
        # candidate improved rows/cols (O(n·k) witness tests): restrict
        # the product to the smaller projection instead of a dense n²
        # pass
        u_mask, v_mask = _improve_candidates(dist, A_full, wn_d, B_full,
                                             s_dn, d_dn)
        u_mask = host(u_mask)[:, :kd]            # [n, kd]
        v_mask = host(v_mask)[:kd, :]            # [kd, n]
        # Group decreased edges by preferred product projection: an edge
        # goes to the col-product if its destination set is narrower
        # than its source set; each group's product covers all its
        # edges' improved pairs. The two products commute: both take
        # min with the same exact via-values.
        prod_cols = np.zeros(n_nodes, bool)
        prod_rows = np.zeros(n_nodes, bool)
        for e in range(kd):
            nu, nv = int(u_mask[:, e].sum()), int(v_mask[e].sum())
            if nv <= nu:
                prod_cols |= v_mask[e]
            else:
                prod_rows |= u_mask[:, e]
        if up.any():
            # mixed event: the witness tests compare against OLD
            # distances, which increases may have stale-LOW — widening
            # with the increase projections restores the cover,
            # provided both products run.
            prod_cols |= colU
            prod_rows |= rowU
        chg_c_np = np.zeros(n_nodes, bool)
        chg_r_np = np.zeros(n_nodes, bool)
        # per-product-pass changed flags, kept separate so the
        # downstream nh/fixpoint grouping sees each pass's NARROW
        # projection instead of the cross-shaped union
        dn_pseudo: list[tuple[np.ndarray, np.ndarray]] = []

        def spread(flags: torch.Tensor, idx: np.ndarray) -> np.ndarray:
            """A block's per-column (or per-row) flags at their nodes."""
            out = np.zeros(n_nodes, bool)
            out[idx] = host(flags)[:len(idx)]
            return out

        def note(c: np.ndarray, r: np.ndarray) -> None:
            chg_c_np[:] |= c
            chg_r_np[:] |= r
            dn_pseudo.append((c, r))

        cost_prod = 0
        if prod_cols.any():
            cost_prod += n_nodes * _pow2(int(prod_cols.sum()))
        if prod_rows.any():
            cost_prod += _pow2(int(prod_rows.sum())) * n_nodes
        if cost_prod > n_nodes * n_nodes:
            # grouped blocks degenerate: one dense product
            if up.any():
                dist, iv_c, iv_r = _apply_up_inval_dense(dist, s_u, d_u,
                                                         wo_u)
                # every pair the dense inval INF'd must reach a rebuild
                # block, or a near-crossing pair the product doesn't
                # improve would be stranded at +inf
                note(host(iv_c), host(iv_r))
            dist, chg_c, chg_r = _improve_block(dist, A_full, wn_d, B_full)
            cells += n_nodes * n_nodes
            chg_c_np |= host(chg_c)
            chg_r_np |= host(chg_r)
            dn_pseudo.append((chg_c_np.copy(), chg_r_np.copy()))
        else:
            if prod_cols.any():
                v_idx = np.nonzero(prod_cols)[0]
                cols = index_block(v_idx)
                seed_blk = _take(dist, cols, 1)
                if up.any():
                    iv_blk = _up_inval_cols(dist, cols, s_u, d_u, wo_u)
                    seed_blk = torch.where(iv_blk, INF, seed_blk)
                    # pairs this pass INF'd must reach a rebuild block
                    note(spread(iv_blk.any(dim=0), v_idx),
                         host(iv_blk.any(dim=1)))
                d_blk, chg_c_blk, chg_r_blk = _improve_block(
                    seed_blk, A_full, wn_d, _take(B_full, cols, 1))
                dist = _scatter_cols(dist, cols, d_blk)
                note(spread(chg_c_blk, v_idx), host(chg_r_blk))
                cells += cols.shape[0] * n_nodes
            if prod_rows.any():
                u_idx = np.nonzero(prod_rows)[0]
                rws = index_block(u_idx)
                seed_blk = _take(dist, rws)
                if up.any():
                    iv_blk = _up_inval_rows(dist, rws, s_u, d_u, wo_u)
                    seed_blk = torch.where(iv_blk, INF, seed_blk)
                    note(host(iv_blk.any(dim=0)),
                         spread(iv_blk.any(dim=1), u_idx))
                d_blk, chg_c_blk, chg_r_blk = _improve_block(
                    seed_blk, _take(A_full, rws), wn_d, B_full)
                dist = _scatter_rows(dist, rws, d_blk)
                note(host(chg_c_blk), spread(chg_r_blk, u_idx))
                cells += rws.shape[0] * n_nodes
        colU = colU | chg_c_np
        rowU = rowU | chg_r_np

    cols_np = np.nonzero(colU)[0]
    rows_np = np.nonzero(rowU)[0]
    n_cols, n_rows = len(cols_np), len(rows_np)
    if n_cols == 0 and n_rows == 0:
        return dist, nh, cells
    # pure-decrease events: dist is already exact everywhere after the
    # product; only the next hops of the changed block need refreshing.
    # Any increase requires the restricted fixpoint.
    need_fix = bool(up.any())
    # invalidation state: with decreases present the pass above already
    # INF'd every invalidated pair; otherwise the passes below apply
    # invalidation on their gathered blocks
    inval_applied = bool(dn.any())

    state_src = host(state.src)
    state_active = host(state.active)
    deg = np.bincount(state_src[state_active], minlength=n_nodes)
    cost_full = E * n_nodes

    def cost_of(nc, nr, rows_sel):
        c = E * _pow2(max(nc, 1))
        r = _pow2(max(int(deg[rows_sel].sum()), 1)) * n_nodes
        return c, r

    def col_pass(dist, nh, cols_sel, fix):
        cols = index_block(cols_sel)
        d_cols = _take(dist, cols, 1)
        if fix:
            if not inval_applied:
                d_cols = torch.where(
                    _up_inval_cols(dist, cols, s_u, d_u, wo_u), INF, d_cols)
            d_cols = _fix_block(state, n_nodes, d_cols, max_hops)
            dist = _scatter_cols(dist, cols, d_cols)
        nh = _scatter_cols(nh, cols, _nh_block(state, n_nodes, d_cols))
        return dist, nh, cols.shape[0] * n_nodes

    def row_pass(dist, nh, rows_sel, fix):
        rows_j = index_block(rows_sel, fill=n_nodes)
        B = rows_j.shape[0]
        row_map = np.full(n_nodes + 1, B, np.int32)
        row_map[rows_sel] = np.arange(len(rows_sel), dtype=np.int32)
        sel_np = np.nonzero(state_active & (row_map[state_src] < B))[0]
        sel_j = padded(sel_np, _pow2(max(len(sel_np), 1)), E, I32)
        row_map_j = on_dev(row_map, I32)
        d_rows = _take(dist, rows_j)
        if fix:
            if not inval_applied:
                d_rows = torch.where(
                    _up_inval_rows(dist, rows_j, s_u, d_u, wo_u), INF,
                    d_rows)
            d_rows = _fix_rows_block(state, dist, d_rows, rows_j, row_map_j,
                                     sel_j, max_hops)
        nh_rows = _nh_rows_block(state, dist, d_rows, rows_j, row_map_j,
                                 sel_j)
        k = len(rows_sel)  # the padding rows (index n_nodes) are dropped
        if fix:
            dist = _scatter_rows(dist, rows_j[:k], d_rows[:k])
        nh = _scatter_rows(nh, rows_j[:k], nh_rows[:k])
        return dist, nh, B * n_nodes

    # Three candidate strategies, cheapest estimated cost wins:
    # (1) ONE block on the union — right when the whole event leans one
    #     way;
    # (2) GROUPED: one column pass for the col-preferring edges, then
    #     one row pass for the rest. Ordering makes this exact: the
    #     column pass rebuilds every invalidated pair whose column is in
    #     its block, so by the time the row pass runs, all non-block
    #     rows it reads are final;
    # (3) DENSE seeded fixpoint, when both of the above degenerate.
    cost_col, cost_row = cost_of(n_cols, n_rows, rows_np)
    cost_union = min(cost_col, cost_row)

    per_edge: list[tuple[np.ndarray, np.ndarray]] = []
    if pcK is not None:
        per_edge += [(pcK[e], prK[e]) for e in range(pcK.shape[0])]
    if dn.any():
        # decreases: group by each product pass's ACTUAL changed set
        per_edge.extend(dn_pseudo)
    group_cols = np.zeros(n_nodes, bool)
    group_rows = np.zeros(n_nodes, bool)
    cost_grouped = None
    if per_edge:
        for col_e, row_e in per_edge:
            rows_sel = np.nonzero(row_e)[0]
            c_c, c_r = cost_of(int(col_e.sum()), len(rows_sel), rows_sel)
            if c_c <= c_r:
                group_cols |= col_e
            else:
                group_rows |= row_e
        cost_grouped = 0
        if group_cols.any():
            cost_grouped += cost_of(int(group_cols.sum()), 0, [])[0]
        if group_rows.any():
            gr = np.nonzero(group_rows)[0]
            cost_grouped += cost_of(0, len(gr), gr)[1]

    best = min(cost_union, cost_full,
               cost_grouped if cost_grouped is not None else cost_full + 1)
    if best == cost_full:
        if need_fix:
            if not inval_applied:
                dist, _ic, _ir = _apply_up_inval_dense(dist, s_u, d_u, wo_u)
            dist = refine_dist(state, n_nodes, dist, max_hops, dst_chunk)
        nh = next_hop_edges(state, dist, n_nodes, dst_chunk)
        return dist, nh, cells + n_nodes * n_nodes
    if best == cost_union or cost_grouped is None:
        if cost_col <= cost_row:
            dist, nh, c = col_pass(dist, nh, cols_np, need_fix)
        else:
            dist, nh, c = row_pass(dist, nh, rows_np, need_fix)
        return dist, nh, cells + c
    if group_cols.any():
        dist, nh, c = col_pass(dist, nh, np.nonzero(group_cols)[0],
                               need_fix)
        cells += c
    if group_rows.any():
        dist, nh, c = row_pass(dist, nh, np.nonzero(group_rows)[0],
                               need_fix)
        cells += c
    return dist, nh, cells
